"""Percent: the least time the card could take for the CKKS work of the
traced part (work/ckks.py against peaks.json: rotations or matrix-vector
products) over the device time of all its kernels, copies left out."""


def read(r):
    return r.roofline("ckks")
