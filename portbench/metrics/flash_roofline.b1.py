"""The flash kernel's share of its roofline over the traced requests'
prefills: one launch a layer over the real prompt rows (``counts.flash``)
over the device time of ``flash_fwd_kernel``."""

from portbench import counts
from portbench.bench.readers import device_share
from portbench.programs.tts import rows


def read(run):
    lm = run.cfg["token_lm"]
    hd = lm["dim"] // lm["n_heads"]

    def bound(rec):
        return sum(lm["n_layers"] * counts.bound_s(*counts.flash(n_pre, lm["n_heads"], hd), counts.BF16_FLOP_PER_S)
                   for n_pre, _, _, _ in rows(rec))

    return device_share(run, "flash_fwd_kernel", bound)
