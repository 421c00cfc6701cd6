// Packed-layout flash-attention forward for Hopper (sm_90a).
//
// Replaces genima_tpu/kernels/packed_attention.py::_packed_kernel (resident
// K/V) and ::_streaming_kernel (online softmax over key blocks): one kernel
// covers both, since a block's shared memory cannot hold a 4096-row K/V.
// Its training variant also replaces ::_packed_kernel_lse: the same kernel,
// instantiated to write L = m + log(l) per (row, head) as well, the softmax
// normaliser the backward (packed_attention_bwd.cu) rebuilds P from.
//
// Layout: q, k, v and o are (B, S, heads * d) bf16, row-major, exactly as
// the to_q / to_k / to_v projections emit them; d a multiple of 8 (the
// wrapper zero-pads any other head dim to the next multiple of 8 and passes
// the real one as scale_dim; above 256 the wide kernels of
// attention_fwd_hopper.cuh: at five or six 64-column atoms the paired
// kernel, two warpgroups of one block, else O in chunks of three or four atoms,
// one a block), Sq and Sk any length >= 1, as the TPU forward's. A block
// reads head h as the d columns at offset h * d with row stride
// C = heads * d, through 3-D (C, S, B) TMA maps, so no (S, H, D) ->
// (H, S, D) transpose ever touches device memory. L is (B, S, heads) f32.
//
// The kernel is attention_fwd_hopper.cuh's, shared with B3
// (flash_attention.cu): a producer warp or warpgroup streams K/V tiles by TMA
// through an mbarrier ring to 1-3 consumer warpgroups of 64 query rows on
// wgmma, online softmax in registers; its note gives the bound (tensor-core
// operations at the SD levels), the design and how head dims other than 64
// are read. B1 and B2a are its instantiations without and with the L store,
// at the same (nwg, bn) for the same shape, so B2a's output is B1's bit for
// bit; kernels/packed_attention.py::forward_plan picks the consumer
// warpgroups, the key tile (64 or 128: Sq and Sk are multiples of 64) and
// the ring depth (python -m genima_torch.tune_kernels packed times every
// candidate). Head dims up to 64 take every tile; 72..192 (two or three
// 64-column atoms) take 64-key tiles with one or two warpgroups; 200..256
// (four atoms) 64-key tiles with one.
//
// On f32 q, k and v, B1 and B2a are attention_f32_hopper.cuh's forward
// instead (3xTF32 on the tensor cores: its note gives the design), with f32
// o and L: the TPU kernels write their output in q's dtype.

#include "attention_f32_hopper.cuh"
#include "attention_fwd_hopper.cuh"

using namespace attn_hopper;

extern "C" int packed_attention_smem_bytes(int nwg, int bn, int stages, int d);

namespace {

template <int DA, bool kWriteLse>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const FwdParams& p, int batch, int nwg, int bn, cudaStream_t s) {
  if (bn == 64 && nwg == 1) return launch_fwd<DA, 1, 64, kWriteLse>(mq, mk, mv, p, batch, s);
  if constexpr (DA == 1) {
    if (nwg == 1) return launch_fwd<1, 1, 128, kWriteLse>(mq, mk, mv, p, batch, s);
    if (nwg == 2) return launch_fwd<1, 2, 128, kWriteLse>(mq, mk, mv, p, batch, s);
    return launch_fwd<1, 3, 128, kWriteLse>(mq, mk, mv, p, batch, s);
  } else if constexpr (DA < 4) {
    return launch_fwd<DA, 2, 64, kWriteLse>(mq, mk, mv, p, batch, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kWriteLse>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int sq,
            int sk, int heads, int d, int scale_dim, int nwg, int bn, int stages, int splits,
            cudaStream_t s) {
  if (packed_attention_smem_bytes(nwg, bn, stages, d) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_atoms(d) > kNarrowAtoms)
    return forward_wide<kWriteLse>(q, k, v, o, lse, batch, sq, sk, heads, d, scale_dim, nwg, bn,
                                   stages, splits, s);
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  FwdParams p;
  const int rc = prepare_fwd(&mq, &mk, &mv, &p, q, k, v, o, lse, batch, sq, sk, heads, d,
                             scale_dim, nwg, bn, stages);
  if (rc) return rc;
  switch (head_atoms(d)) {
    case 1: return launch<1, kWriteLse>(mq, mk, mv, p, batch, nwg, bn, s);
    case 2: return launch<2, kWriteLse>(mq, mk, mv, p, batch, nwg, bn, s);
    case 3: return launch<3, kWriteLse>(mq, mk, mv, p, batch, nwg, bn, s);
    default: return launch<4, kWriteLse>(mq, mk, mv, p, batch, nwg, bn, s);
  }
}

}  // namespace

extern "C" {

// Shared memory a block of the (nwg, bn) kernel asks for at `stages` and
// head dim d; 0 for a launch there is no kernel for.
int packed_attention_smem_bytes(int nwg, int bn, int stages, int d) {
  if (!head_dim_ok(d, d) || stages < 1) return 0;
  // one atom: (1, 64) and (1 to 3, 128), as 64-key tiles with more
  // warpgroups never won; two or three: (1 or 2, 64), four: (1, 64), what
  // their registers and shared memory leave; five or six: the paired
  // kernel's (2, 64); more: the streaming wide kernel's (1, 64)
  const int atoms = head_atoms(d);
  if (atoms > kNarrowAtoms)
    return wide_launch_smem(nwg, bn, d, stages);
  const bool tile = atoms == 1 ? (bn == 64 ? nwg == 1 : bn == 128 && nwg >= 1 && nwg <= 3)
                               : bn == 64 && (nwg == 1 || (atoms < 4 && nwg == 2));
  return tile ? fwd_smem_bytes(nwg, bn, stages, atoms) : 0;
}

// softmax(Q_h K_h^T / sqrt(scale_dim)) V_h for every head h of packed
// (B, S, heads * d) bf16 tensors, with the consumer warpgroups (nwg), key
// tile (bn), ring depth and key splits (1 but in the wide kernels) of
// kernels/packed_attention.py::forward_plan; scale_dim is d, or the real
// head dim of heads zero-padded to d columns.
// Needs 16-byte aligned tensors (the wrapper checks). Launches on `stream`,
// does not synchronise; returns 0 or an error code for
// packed_attention_error_string.
int packed_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                         int sk, int heads, int d, int scale_dim, int nwg, int bn, int stages,
                         int splits, void* stream) {
  return forward<false>(q, k, v, o, nullptr, batch, sq, sk, heads, d, scale_dim, nwg, bn, stages,
                        splits, static_cast<cudaStream_t>(stream));
}

// The same, and L = m + log(l) per (row, head) into the (B, Sq, heads) f32
// tensor `lse`.
int packed_attention_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse,
                             int batch, int sq, int sk, int heads, int d, int scale_dim, int nwg,
                             int bn, int stages, int splits, void* stream) {
  return forward<true>(q, k, v, o, static_cast<float*>(lse), batch, sq, sk, heads, d, scale_dim,
                       nwg, bn, stages, splits, static_cast<cudaStream_t>(stream));
}

// B1 and B2a on packed (B, S, heads * d) f32 tensors, d a multiple of 4
// (the wrapper zero-pads any other head dim and passes the real one as
// scale_dim; above 256 the wide f32 kernel), Sq and Sk >= 1, with the
// consumer warpgroups, key tile and ring depth of
// kernels/flash_attention.py::f32_plan; L into `lse` when it is not null.
// Launches on `stream`, does not synchronise; returns 0 or an error code
// for packed_attention_error_string.
int packed_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                             int batch, int sq, int sk, int heads, int d, int scale_dim, int nwg,
                             int bn, int stages, int splits, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  return l ? attn_f32::forward<true, false>(q, k, v, o, l, batch, sq, sk, heads, d, scale_dim,
                                            nwg, bn, stages, s)
           : attn_f32::forward<false, false>(q, k, v, o, l, batch, sq, sk, heads, d, scale_dim,
                                             nwg, bn, stages, s);
}

// Shared memory a block of the f32 forward asks for with (nwg, bn, stages)
// at head dim d (0 for a launch there is no kernel for).
int packed_attention_f32_smem_bytes(int nwg, int bn, int stages, int d) {
  if (!attn_f32::head_dim_ok(d, d) || stages < 1) return 0;
  const int da = attn_f32::head_atoms(d);
  return attn_f32::fwd_launch_smem<false>(da, nwg, bn, stages);
}

const char* packed_attention_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
