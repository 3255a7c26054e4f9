"""MCA ``threads`` framework — the host tier's threading substrate.

Copy of ``ompi_tpu/mca/threads/__init__.py`` (after the reference's
``opal/mca/threads/``).  Python-level thread concurrency is absorbed by
:mod:`threading`, so what this framework provides is a worker pool that
runs the host data path's tight loops (memcpy, datatype pack/unpack,
elementwise reductions) in parallel.  Components compete to provide the
pool: ``threads/native`` (40, the C++ worker pool of the native core,
``ompi_tpu_torch/native``) wherever the core is built, else
``threads/python`` (a ``ThreadPoolExecutor``; numpy releases the GIL in its
loops), which is always available.
"""
