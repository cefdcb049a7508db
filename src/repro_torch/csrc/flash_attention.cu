// Causal GQA flash-attention forward at the default tiles, 64-row q tiles
// and kv blocks of 64 keys, for head dims 64, 80 (zamba2's shared
// attention) and 128 (the launch every untuned call makes). The kernel is flash_attention.cuh's; the other
// tiles are built by flash_attention_q64.cu and flash_attention_q128.cu.

#include "flash_attention.cuh"

#define CASES(X) X(64, 64, 64) X(80, 64, 64) X(128, 64, 64)
FLASH_C_INTERFACE(CASES)
