"""Serving gateway: streaming HTTP frontend over the continuous-batching
scheduler — admission control, per-tenant fair queuing, graceful lifecycle.
Port of ``deepspeed_tpu/serving/`` without the elastic controller: a fleet
of replicas (phase roles for disaggregated prefill/decode) on one card, or
across the ranks of a mesh (rank 0 serves, the others :func:`follow`), and
the multi-host router over worker processes (``serving/router.py``).

Quickstart::

    python -m deepspeed_tpu_torch.serving --model gpt2-large --config cfg.json --port 8000

    curl -N localhost:8000/v1/completions -d \\
      '{"prompt": [5, 6, 7], "max_tokens": 16, "stream": true}'
"""

from ..inference.config import GatewayConfig  # noqa: F401
from .fair_queue import FairQueue, QueueFull  # noqa: F401
from .replica import Replica, ReplicaSet  # noqa: F401
from .gateway import Gateway, follow  # noqa: F401
from .router import Router, WorkerAgent  # noqa: F401
