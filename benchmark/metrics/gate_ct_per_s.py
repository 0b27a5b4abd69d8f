"""gate_ct_per_s: ciphertexts through the gate step per second: batch times
the steps that the device finished inside the window, over the window."""


def read(run):
    w = run.window
    if "ct_done" not in w or not w["ct_done"]:
        return None
    return w["ct_done"] / w["seconds"]
