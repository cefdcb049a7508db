// Causal GQA flash-attention forward at 64-row q tiles with kv blocks of
// 32 or 128 keys (flash_attention.cuh), at head dims 64, 80 and 128. At
// head dim 128 a kv block of 128 keys needs 295,936 bytes of shared
// memory, over the 232,448 a block may have: it is not built, and the
// wrapper's budget refuses it.

#include "flash_attention.cuh"

#define CASES(X) X(64, 64, 32) X(64, 64, 128) X(80, 64, 32) X(80, 64, 128) \
                 X(128, 64, 32)
FLASH_C_INTERFACE(CASES)
