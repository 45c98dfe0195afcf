"""Model FLOPs of the completed requests at their real lengths (prompt and
generated tokens through the token LM, frames through the CFM's steps and
the vocoder) over their seconds times the H100's dense bf16 peak (989
TFLOP/s); the requests the profiler covered are left out."""

from portbench.bench.readers import mfu


def read(run):
    return mfu(run)
