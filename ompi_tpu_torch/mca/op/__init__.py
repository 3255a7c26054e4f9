"""MCA ``op`` framework — reduction fold components (``ompi/mca/op/``):
``builtin`` (plain torch folds) and ``cuda_vpu`` (hand-written kernels).
"""
