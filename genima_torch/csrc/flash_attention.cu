// Flash-attention forward on (B, S, H, D) for Hopper (sm_90a), any S, D a
// multiple of 8 (the wrapper zero-pads any other D to the next multiple of 8
// and passes the real one as scale_dim): up to 256 the narrow kernel, above
// it attention_fwd_hopper.cuh's wide kernels (at five or six 64-column atoms
// the paired kernel, two warpgroups of one block; else O in chunks of three
// or four atoms, one a block).
//
// Replaces genima_tpu/kernels/flash_attention.py::_flash_forward /
// _flash_kernel: non-causal softmax(Q K^T / sqrt(D)) V with an online
// softmax in f32, P rounded to bf16 before P V, keys at or past Sk masked to
// -1e30 and padded query rows never stored. The JAX wrapper transposes
// (B, S, H, D) to (B*H, S, D) around its kernel, a TPU tiling artifact that
// is not carried over: (B, S, H, D) is the packed (B, S, H*D) layout the
// projections emit, and a block reads head h as the D columns at offset
// h * D with row stride H * D.
//
// The kernel is attention_fwd_hopper.cuh's, shared with B1/B2a
// (packed_attention.cu); its note gives the bound, the design and how head
// dims other than 64 are read. Here it is instantiated without the L store:
// at D up to 64 with 1 or 2 consumer warpgroups and 64-, 80- or 128-key
// tiles, and at 3 with 128-key tiles; at D = 72..192 (two or three
// 64-column atoms) with 1 warpgroup on 64- or 80-key tiles, or 2 on 64-key
// ones; at D = 200..256 (four atoms) with 1 warpgroup on 64- or 80-key
// tiles. kernels/flash_attention.py::plan picks one per shape (python -m
// genima_torch.tune_kernels attn times every candidate).
//
// On f32 q, k and v it is attention_f32_hopper.cuh's forward instead
// (3xTF32 on the tensor cores: its note gives the design), with an f32
// output, as the TPU kernel writes its output in q's dtype.

#include "attention_f32_hopper.cuh"
#include "attention_fwd_hopper.cuh"

using namespace attn_hopper;

namespace {

template <int DA>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const FwdParams& p, int batch, int nwg, int bn, cudaStream_t s) {
  if (nwg == 1 && bn == 64) return launch_fwd<DA, 1, 64, false>(mq, mk, mv, p, batch, s);
  if (nwg == 1 && bn == 80) return launch_fwd<DA, 1, 80, false>(mq, mk, mv, p, batch, s);
  if constexpr (DA == 1) {
    if (nwg == 1 && bn == 128) return launch_fwd<1, 1, 128, false>(mq, mk, mv, p, batch, s);
    if (nwg == 2 && bn == 64) return launch_fwd<1, 2, 64, false>(mq, mk, mv, p, batch, s);
    if (nwg == 2 && bn == 80) return launch_fwd<1, 2, 80, false>(mq, mk, mv, p, batch, s);
    if (nwg == 2) return launch_fwd<1, 2, 128, false>(mq, mk, mv, p, batch, s);
    return launch_fwd<1, 3, 128, false>(mq, mk, mv, p, batch, s);
  } else if constexpr (DA < 4) {
    return launch_fwd<DA, 2, 64, false>(mq, mk, mv, p, batch, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_smem_bytes(int nwg, int bn, int stages, int d);

// softmax(Q_h K_h^T / sqrt(scale_dim)) V_h for every head h of
// (B, S, heads, d) bf16 tensors, Sq and Sk >= 1, with the consumer
// warpgroups (nwg), key tile (bn), ring depth and key splits (1 but in the
// wide kernels) of kernels/flash_attention.py::plan; scale_dim is d, or the
// real head dim of heads zero-padded to d columns. Needs 16-byte aligned tensors (the wrapper
// checks). Launches on `stream`, does not synchronise; returns 0 or an error
// code for flash_attention_error_string.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                        int sk, int heads, int d, int scale_dim, int nwg, int bn, int stages,
                        int splits, void* stream) {
  if (flash_attention_smem_bytes(nwg, bn, stages, d) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_atoms(d) > kNarrowAtoms)
    return forward_wide<false>(q, k, v, o, nullptr, batch, sq, sk, heads, d, scale_dim, nwg, bn,
                               stages, splits, s);
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  FwdParams p;
  const int rc = prepare_fwd(&mq, &mk, &mv, &p, q, k, v, o, nullptr, batch, sq, sk, heads, d,
                             scale_dim, nwg, bn, stages);
  if (rc) return rc;
  switch (head_atoms(d)) {
    case 1: return launch<1>(mq, mk, mv, p, batch, nwg, bn, s);
    case 2: return launch<2>(mq, mk, mv, p, batch, nwg, bn, s);
    case 3: return launch<3>(mq, mk, mv, p, batch, nwg, bn, s);
    default: return launch<4>(mq, mk, mv, p, batch, nwg, bn, s);
  }
}

// Shared memory a block of the (nwg, bn) kernel asks for at `stages` and
// head dim d; 0 for a launch there is no kernel for.
int flash_attention_smem_bytes(int nwg, int bn, int stages, int d) {
  if (!head_dim_ok(d, d) || stages < 1) return 0;
  const int atoms = head_atoms(d);
  if (atoms > kNarrowAtoms)  // the wide kernels: the paired (2, 64), the streaming (1, 64)
    return wide_launch_smem(nwg, bn, d, stages);
  const bool tile =
      atoms == 1 ? (nwg == 3 ? bn == 128
                             : (nwg == 1 || nwg == 2) && (bn == 64 || bn == 80 || bn == 128))
                 : (nwg == 1 && (bn == 64 || bn == 80)) || (atoms < 4 && nwg == 2 && bn == 64);
  return tile ? fwd_smem_bytes(nwg, bn, stages, atoms) : 0;
}

// The same on (B, S, heads, d) f32 tensors, d a multiple of 4 (the wrapper
// zero-pads any other head dim and passes the real one as scale_dim; above
// 256 the wide f32 kernel), Sq and Sk >= 1, with the consumer warpgroups, key tile and
// ring depth of kernels/flash_attention.py::f32_plan.
int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, int batch,
                            int sq, int sk, int heads, int d, int scale_dim, int nwg, int bn,
                            int stages, int splits, void* stream) {
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  return attn_f32::forward<false, true>(q, k, v, o, nullptr, batch, sq, sk, heads, d, scale_dim,
                                        nwg, bn, stages, static_cast<cudaStream_t>(stream));
}

// Shared memory a block of the f32 forward asks for with (nwg, bn, stages)
// at head dim d (0 for a launch there is no kernel for).
int flash_attention_f32_smem_bytes(int nwg, int bn, int stages, int d) {
  if (!attn_f32::head_dim_ok(d, d) || stages < 1) return 0;
  const int da = attn_f32::head_atoms(d);
  return attn_f32::fwd_launch_smem<true>(da, nwg, bn, stages);
}

const char* flash_attention_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
