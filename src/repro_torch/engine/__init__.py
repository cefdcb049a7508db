"""Continuous-batching serving engine over a paged KV pool."""
from repro_torch.engine.engine import (EngineConfig, InferenceEngine, PHASES,
                                       Request)
from repro_torch.engine.pagetable import (NULL_PAGE, PagePoolExhausted,
                                          PageTable, PrefixTree)
from repro_torch.engine.step import (build_chunk_prefill, build_engine_prefill,
                                     build_page_scatter, build_paged_decode,
                                     engine_compatible)

__all__ = [
    "EngineConfig", "InferenceEngine", "PHASES", "Request",
    "NULL_PAGE", "PagePoolExhausted", "PageTable", "PrefixTree",
    "build_chunk_prefill", "build_engine_prefill", "build_page_scatter",
    "build_paged_decode", "engine_compatible",
]
