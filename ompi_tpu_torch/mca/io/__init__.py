"""io — the MPI-IO framework (the reference's ``ompi/mca/io/``).

Copy of ``ompi_tpu/mca/io/``.  Components compete per file the way coll
components compete per communicator: ``file_query(file)`` returns
``(priority, module)``; the highest priority wins and its module serves
every I/O operation on that file.  The one built-in component is ``ompio``,
the reference's native MPI-IO stack (io/ompio with its fs, fbtl, fcoll and
sharedfp sub-frameworks) collapsed into one module.
"""
