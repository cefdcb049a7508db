// Causal GQA flash-attention forward at 128-row q tiles (512 threads, one
// CTA an SM) with kv blocks of 32, 64 or 128 keys (flash_attention.cuh),
// at head dims 64, 80 and 128.
// At head dim 128 a kv block of 128 keys needs 313,344 bytes of shared
// memory, over the 232,448 a block may have: it is not built, and the
// wrapper's budget refuses it.

#include "flash_attention.cuh"

#define CASES(X) X(64, 128, 32) X(64, 128, 64) X(64, 128, 128) \
                 X(80, 128, 32) X(80, 128, 64) X(80, 128, 128)   \
                 X(128, 128, 32) X(128, 128, 64)
FLASH_C_INTERFACE(CASES)
