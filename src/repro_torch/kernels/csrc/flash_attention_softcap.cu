// Flash-attention forward with attention logit soft-capping: the
// instantiations of flash_attention.cu's flash_wgmma_kernel with CAP true,
// for both routes and every padded head dim, behind the same C entry
// points (flash_attention_wgmma_launch, flash_attention_split_f32_launch,
// flash_attention_wgmma_resources) with softcap > 0.
//
// Replaces the Pallas TPU kernel flash_attention_fwd of
// src/repro/kernels/flash_attention/kernel.py where the model sets
// attn_logit_softcap: the Pallas kernel has no cap, and the reference model
// sends a capped prefill through blocked_attention (its twin,
// src/repro/models/attention.py), which applies s = tanh(s / cap) * cap to
// the scaled scores before the mask. Here that is one tanhf a score in the
// score tile, between the scale and the mask; nothing else changes.
//
// Bound: operations, as the cap-free kernel's -- 4 * dh flops per unmasked
// (query, key) pair per query head; the cap adds one tanhf a pair, on the
// CUDA cores.
//
// Its own translation unit, so that nvcc builds it beside the cap-free
// library rather than after it; the build hashes the included file too.

#define FLASH_SOFTCAP 1
#include "flash_attention.cu"
