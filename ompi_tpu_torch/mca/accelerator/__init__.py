"""accelerator — device-memory framework (``opal/mca/common/cuda``'s
residency test, ``opal_cuda_check_bufs``): ``torch_acc`` says whether a
buffer lives on the device world's device (a torch tensor) or in host
memory (numpy).  It has no component to select yet: its users are the
device world's, which has one device type."""
