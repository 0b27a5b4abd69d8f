"""Multi-device execution with ``torch.distributed``: the (batch, crt) mesh,
the crt-sharded gate step and the NTT across devices (``mesh.py``), the
entry point that starts the ranks for one call (``run.py``), and the
resident mesh whose rank 0 is the caller (``session.py``)."""
