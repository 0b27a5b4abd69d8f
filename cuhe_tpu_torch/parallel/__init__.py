"""Multi-device execution with ``torch.distributed``: the (batch, crt) mesh,
the crt-sharded gate step and the NTT across devices (``mesh.py``), and the
entry point that starts the ranks (``run.py``)."""
