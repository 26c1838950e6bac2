"""tpurag_torch: the PyTorch + CUDA port of tpurag.

The JAX package ``tpurag`` is the reference; this package carries the
hybrid query path (dense top-k + BM25 + RRF fusion) on one NVIDIA H100
through hand-written CUDA kernels (``tpurag_torch/csrc``), with a plain
PyTorch version of each kernel for CPU tensors. It imports torch and
numpy, never jax and never tpurag.

Public API: :class:`KnowledgeBase` (``device="cuda"`` by default).
"""

__version__ = "0.1.0"

from tpurag_torch.api.knowledge_base import KnowledgeBase  # noqa: F401
from tpurag_torch.core.config import EngineConfig, HybridPreset, PRESETS  # noqa: F401
from tpurag_torch.core.types import Chunk, SearchResult, SearchResponse  # noqa: F401
from tpurag_torch.ingest.chunker import chunk_text  # noqa: F401
from tpurag_torch.ingest.tokenizer import tokenize  # noqa: F401
