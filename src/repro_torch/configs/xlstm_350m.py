"""xlstm-350m [ssm]: 24L, d=1024, 4H, vocab=50304, d_ff=0 (blocks carry
their own projections). mLSTM:sLSTM = 7:1 interleave. Sub-quadratic —
runs long_500k. [arXiv:2405.04517]

Counterpart of ``repro/configs/xlstm_350m.py``.
"""

from repro_torch.configs import base
from repro_torch.models.common import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    superblock=tuple(
        [LayerSpec(kind="mlstm", mlp="") for _ in range(7)]
        + [LayerSpec(kind="slstm", mlp="")]
    ),
    n_superblocks=3,
    ssm=SSMConfig(kind="mlstm", d_state=16, d_inner=1024, chunk=128),
    sub_quadratic=True,
)

SMOKE = base.shrink(
    CONFIG,
    superblock=(LayerSpec(kind="mlstm", mlp=""), LayerSpec(kind="slstm", mlp="")),
)
