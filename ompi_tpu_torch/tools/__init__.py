"""Command-line tools of the port: ``tpurun``, the launcher."""
