"""papc_tpu — a JAX point-cloud deep-learning platform.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of AgentMaker/PAPC
(reference: PaddlePaddle, /root/reference). One unified stack instead of the
reference's two: classification, segmentation and detection share a single
functional kernel library (`papc_tpu.ops`), module library
(`papc_tpu.nn`), model zoo (`papc_tpu.models`), data pipeline
(`papc_tpu.data`) and trainer (`papc_tpu.train`).

Design rules:
  * channel-LAST layout ``[B, N, C]`` everywhere internally — shared-MLPs
    lower to plain matmuls over the channel axis (the reference uses
    paddle's ``[B, C, N]`` Conv1D layout);
  * static shapes only — ragged neighborhoods are padded + masked;
  * no host round-trips in any hot path (the reference syncs to numpy
    inside FPS/ball-query/gather — see its
    PAPC/models/layers/pointnet2_basic_layers.py:43-126);
  * parallelism via ``jax.sharding.Mesh`` + NamedSharding, collectives
    inserted by XLA (NCCL over NVLink between the GPUs of a host).
"""

__version__ = "0.1.0"
