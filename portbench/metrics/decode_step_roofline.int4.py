"""The int4 decode step's share of its roofline: the benchmark's least time
of each launch in the traced requests (``counts.decode_step`` at the
launch's live keys) over the device time of ``mega_persistent_kernel``."""

from portbench import counts
from portbench.bench.readers import device_share
from portbench.programs.tts import rows

BITS = 4


def read(run):
    if run.cfg.get("quantize_lm_int4", False) != (BITS == 4):
        return None
    lm = run.cfg["token_lm"]

    def bound(rec):
        return sum(counts.bound_s(*counts.decode_step(lm, BITS, n_pre + i - 1), counts.INT8_OP_PER_S)
                   for n_pre, _, _, steps in rows(rec) for i in range(1, steps + 1))

    return device_share(run, "mega_persistent_kernel", bound)
