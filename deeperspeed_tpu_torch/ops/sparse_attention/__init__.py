from .sparsity_config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
    sparsity_config_from_dict,
)
from .kernels import (
    block_sparse_attention_xla,
    build_lut,
    layout_density,
    make_block_sparse_attention,
)
from .sparse_self_attention import BertSparseSelfAttention, SparseSelfAttention
from .sparse_attention_utils import SparseAttentionUtils
