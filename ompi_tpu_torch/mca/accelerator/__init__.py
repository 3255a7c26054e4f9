"""accelerator — device-memory framework (``opal/mca/common/cuda``'s
residency test, ``opal_cuda_check_bufs``): ``torch_acc`` says whether a
buffer lives on the device world's device (a torch tensor) or in host
memory (numpy), stages across, and keeps the host staging pool
(``otpu_accelerator_torch_staging_pool*``).  It has no component to select
yet: its users import it directly, and there is one device type."""
