"""mesh.collective_mb: MB (10^6 bytes) that rank 0 moves in collectives a
step, from the mesh's counters (`CommStats.bytes`: each call's result on
the rank, an all-gather's whole output) over the window's steps."""


def read(run):
    v = run.window.get("collective_bytes_per_step")
    return v / 1e6 if v else None
