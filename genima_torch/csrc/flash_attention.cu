// Flash-attention forward on (B, S, H, 64) for Hopper (sm_90a), any S.
//
// Replaces genima_tpu/kernels/flash_attention.py::_flash_forward /
// _flash_kernel: non-causal softmax(Q K^T / sqrt(64)) V with an online
// softmax in f32, P rounded to bf16 before P V, keys at or past Sk masked to
// -1e30 and padded query rows never stored. The JAX wrapper transposes
// (B, S, H, D) to (B*H, S, D) around its kernel, a TPU tiling artifact that
// is not carried over: (B, S, H, 64) is the packed (B, S, H*64) layout the
// projections emit, and a block reads head h as the 64 columns at offset
// h * 64 with row stride H * 64.
//
// The kernel is attention_fwd_hopper.cuh's, shared with B1/B2a
// (packed_attention.cu); its note gives the bound and the design. Here it
// is instantiated without the L store, at 1 or 2 consumer warpgroups and
// 64-, 80- or 128-key tiles, and at 3 with 128-key tiles;
// kernels/flash_attention.py::plan picks one per shape (python -m
// genima_torch.tune_kernels attn times every candidate).

#include "attention_fwd_hopper.cuh"

using namespace attn_hopper;

extern "C" {

int flash_attention_smem_bytes(int nwg, int bn, int stages);

// softmax(Q_h K_h^T / 8) V_h for every head h of (B, S, heads, 64) bf16
// tensors, Sq and Sk >= 1, with the consumer warpgroups (nwg), key tile
// (bn) and ring depth of kernels/flash_attention.py::plan. Needs 16-byte
// aligned tensors (the wrapper checks). Launches on `stream`, does not
// synchronise; returns 0 or an error code for flash_attention_error_string.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                        int sk, int heads, int nwg, int bn, int stages, void* stream) {
  if (flash_attention_smem_bytes(nwg, bn, stages) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  FwdParams p;
  const int rc = prepare_fwd(&mq, &mk, &mv, &p, q, k, v, o, nullptr, batch, sq, sk, heads, nwg,
                             bn, stages);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nwg == 1 && bn == 64) return launch_fwd<1, 64, false>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 1 && bn == 80) return launch_fwd<1, 80, false>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 1 && bn == 128) return launch_fwd<1, 128, false>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 2 && bn == 64) return launch_fwd<2, 64, false>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 2 && bn == 80) return launch_fwd<2, 80, false>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 2) return launch_fwd<2, 128, false>(mq, mk, mv, p, batch, heads, s);
  return launch_fwd<3, 128, false>(mq, mk, mv, p, batch, heads, s);
}

// Shared memory a block of the (nwg, bn) kernel asks for at `stages`; 0 for
// a launch there is no kernel for.
int flash_attention_smem_bytes(int nwg, int bn, int stages) {
  const bool tile =
      nwg == 3 ? bn == 128 : (nwg == 1 || nwg == 2) && (bn == 64 || bn == 80 || bn == 128);
  if (!tile || stages < 1) return 0;
  return fwd_smem_bytes(nwg, bn, stages);
}

const char* flash_attention_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
