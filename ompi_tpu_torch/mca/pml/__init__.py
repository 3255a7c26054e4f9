"""pml — point-to-point messaging layer framework (``ompi/mca/pml/pml.h``).

Components: ``ob1`` (the matching and protocol engine over BTLs).  The
reference's ``monitoring`` and ``v`` (message logging) interpositions are
not ported.
"""
