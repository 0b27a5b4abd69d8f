"""aes.relin_calls: relinearizations in one AES-128 circuit, from the
circuit's counter (`AESStats.relin_calls`: one a batch of ANDs), the median
over the window's circuits."""


def read(run):
    return run.window.get("relin_calls")
