// In-kernel adapter dropout of the LN kernels: a counter-based 32-bit
// hash of (seed, stream, global element index), the same function as
// ops/dropout.py computes in int64 torch ops, bit for bit.
//
// Replaces the Mosaic PRNG draws of mtlora_tpu/ops/pallas_ln_lora.py
// (_drop_mask, seeded per grid cell from seed[0] / seed[1]) and of
// pallas_ln_mlp.py. Nothing is stored: the forward and the backward hash
// the same indices and get the same mask. An element is kept where the
// hash is >= rate * 2^32; a kept value is multiplied by 1 / (1 - rate)
// rounded to fp32.
#pragma once

#include <stdint.h>

// MurmurHash3's 32-bit finalizer.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The key of stream s, from the int32 seed[s] of the call (device memory).
__device__ __forceinline__ uint32_t drop_key(const int* seed, int stream) {
  return fmix32((uint32_t)seed[stream] +
                0x9E3779B9u * (uint32_t)(stream + 1));
}

// Element (row, col) of a [rows, cols] stream has index row * cols + col
// (mod 2^32).
__device__ __forceinline__ bool drop_keep(uint32_t key, uint32_t row,
                                          uint32_t cols, uint32_t col,
                                          uint32_t threshold) {
  const uint32_t idx = row * cols + col;
  return fmix32(fmix32(idx ^ key) + key) >= threshold;
}
