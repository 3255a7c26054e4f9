"""Built-in otpu-lint passes.  Importing this package registers them all
(the registry order here is the report order)."""
from ompi_tpu_torch.analysis.passes import (  # noqa: F401
    buffer_ownership,
    lock_discipline,
    hot_path,
    observability,
    mca_conformance,
    view_escape,
    typestate,
    coll_match,
)
