"""Set-up seconds: process start to the first timed request (imports, CUDA
context, kernel builds on a checkout's first run, weights, style DB, warm-up)."""


def read(run):
    return run.setup_s
