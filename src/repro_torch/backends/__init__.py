"""Pluggable execution backends (see base.py for the API).  Importing this
package registers ``vmap``, the single-device backend, and ``mesh``, the
replicas over ``torch.distributed`` ranks (``launch/mesh.py``)."""
from repro_torch.backends.base import (  # noqa: F401
    ExecutionBackend, available_backends, get_backend_cls, make_backend,
    register_backend, resolve_backend,
)
from repro_torch.backends.ops import CollectiveOp, WireFormat  # noqa: F401
from repro_torch.backends.vmap import VmapBackend  # noqa: F401
from repro_torch.backends.mesh import MeshBackend  # noqa: F401
