"""Foundation layer: var registry, MCA component architecture, output
streams (copies of ``ompi_tpu/base``), and device resolution (``cudaenv``)."""
