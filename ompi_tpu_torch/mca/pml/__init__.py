"""pml — point-to-point messaging layer framework (``ompi/mca/pml/pml.h``).

Components: ``ob1`` (the matching and protocol engine over BTLs).  The
interpositions wrap the selected module at boot: pml/monitoring
(``runtime/monitoring.py``) and, outside it, pml/v with
vprotocol/pessimist's logging and replay (``vprotocol.py``).
"""
