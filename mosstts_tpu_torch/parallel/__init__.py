"""Parallelism over ``torch.distributed``: the mesh and sharding rules
(``mesh.py``), GPipe pipelining (``pipeline.py``) and ring attention
(``ring_attn.py``). The collectives the sharded forwards call live below
the models, in ``ops/collectives.py``; their public names are re-exported
here."""
from ..ops.collectives import Axis, axis_of, enter, gather, reduce, sharded_dims  # noqa: F401
