"""Compatibility model families for converted CosyVoice-300M checkpoints.

Counterpart of the JAX ``models/compat/``: modules that mirror the
documented topologies of the CosyVoice-300M release artifacts, so that the
weights ``utils/cosyvoice_convert.RULESETS`` converts have a home:

- wenet_conformer: wenet/espnet-style (rel-pos) conformer/transformer
  encoders — llm.pt's text_encoder + LM trunk and flow.pt's token encoder;
- cosy_llm: the TransformerLM wrapper (embeddings, prefix layout,
  autoregressive speech-token generation with a KV cache);
- matcha_unet: Matcha-style conv U-Net CFM estimator + the
  MaskedDiffWithXvec flow wrapper (flow.pt);
- hift: HiFT/NSF vocoder (hift.pt);
- s3_tokenizer / campplus: the speech tokenizer (converted) and the
  speaker encoder (graph-executed);
- engine: CosyEngine serving the converted release through the
  reference's inference API.

Plain PyTorch (the JAX modules are XLA code); the tokenizer's log-mel goes
through the fused log-mel kernel on the card.
"""

from . import cosy_llm, hift, matcha_unet, wenet_conformer  # noqa: F401
from .engine import CosyEngine  # noqa: F401
