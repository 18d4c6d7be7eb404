"""Online serving: deadline batching of moment-retrieval requests over
``BLIP2_MR.generate_dispatch/collect`` (``server.py``); the HTTP face is
``python -m mr_blip_tpu_torch.serve``."""

from mr_blip_tpu_torch.serving.server import (  # noqa: F401
    MomentRetrievalServer,
    MRRequest,
    ServerStats,
)
