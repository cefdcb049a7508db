// Paged single-token GQA decode attention at tiles of 32 and 128 slots a
// CTA, for head dims 64 and 128 (paged_attention.cuh).

#include "paged_attention.cuh"

#define CASES(X) X(64, 32) X(64, 128) X(128, 32) X(128, 128)
PAGED_C_INTERFACE(CASES)
