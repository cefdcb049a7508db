// Paged single-token GQA decode attention at the default tile of 64 slots
// a CTA, for head dims 64 and 128 (the launches every untuned call makes).
// The kernels are paged_attention.cuh's; tiles of 32 and 128 slots are
// built by paged_attention_tiles.cu.

#include "paged_attention.cuh"

#define CASES(X) X(64, 64) X(128, 64)
PAGED_C_INTERFACE(CASES)
