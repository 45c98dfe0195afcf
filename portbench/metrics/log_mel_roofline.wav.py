"""The log-mel kernel's share of its roofline over the traced requests'
featurize calls: per call one launch a leg (16 kHz, then 24 kHz after the
resampler) over the request's two wavs at their real samples
(``counts.log_mel``), over the device time of ``log_mel_kernel``."""

from portbench import counts
from portbench.bench.readers import device_share


def read(run):
    a = run.cfg["audio"]
    legs = ((1, 1, a["prompt_n_fft"], a["prompt_hop_length"], a["prompt_win_length"], a["prompt_n_mels"]),
            (a["sample_rate"], a["prompt_sample_rate"], a["n_fft"], a["hop_length"], a["win_length"], a["n_mels"]))

    def bound(rec):
        total = 0.0
        for num, den, n_fft, hop, win, n_mels in legs:
            nbytes, ops = counts.log_mel_shared(n_fft, win, n_mels), 0.0
            for w in rec["kept"]["wavs"]:
                b, o, _ = counts.log_mel(-(-len(w) * num // den), n_fft, hop, win, n_mels)
                nbytes, ops = nbytes + b, ops + o
            total += counts.bound_s(nbytes, ops, counts.LOGMEL_PEAK)
        return total

    return device_share(run, "log_mel_kernel", bound)
