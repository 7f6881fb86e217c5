"""Model families (port of ``ray_tpu/models``).

``llama`` — decoder-only LM (flash/ring/Ulysses attention, MoE variant).
``vit`` — Vision Transformer image classifier.
"""

from ray_tpu_torch.models import llama, vit  # noqa: F401
