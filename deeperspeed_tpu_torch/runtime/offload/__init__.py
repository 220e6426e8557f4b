"""ZeRO-Infinity: the streamed offload engine (streaming.py), its NVMe
state tier (swapper.py) and the ``"aio"`` config block (aio_config.py)."""
