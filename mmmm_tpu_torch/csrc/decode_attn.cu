// K1: single-token decode attention against a (B, H, Smax, D) KV cache, and
// its fused form, which first appends this step's K/V row (K2's work) in
// the same launch.
//
// Replaces: mmmm_tpu/ops/decode_kernel.py decode_attention_pallas, both of
// its TPU forms: _decode_attention_pallas_full (Pallas body `_decode_kernel`)
// and decode_attention_pallas_ragged (`_decode_kernel_ragged`). The two
// existed only because a full K+V read overflowed VMEM on long caches; one
// length-aware kernel covers both here. The fused form also replaces
// kv_append_pallas (`_kv_append_kernel`) on the decode step, which always
// appends to the cache it then reads.
//
// What bounds it on an H100: bytes. Each call reads the valid K and V rows
// once (about 16.8 MB at B=4, H=32, D=128, kv_len 256 in bf16) and does two
// FLOPs per byte, so the least time is ~5 us at 3.35 TB/s.
//
// Design: a block of 8 warps takes the valid slots [0, len) of a (sample,
// head), len = clamp(kv_len[b], 0, Smax), or one of S even runs of them
// where the B x H heads alone would leave SMs idle: then the S blocks are a
// thread-block cluster (S <= 8; ops/decode_kernel.py decode_splits reads the
// shapes only; an empty run gives an empty partial). A block's run is
// shared evenly by its warps, and each warp requests all of its K rows and
// all of its V rows as the block starts, on two mbarriers of its own,
// through the staged read of decode_q8_stage.cuh (1-D bulk copies; head and
// tail bytes by the lanes where a run's ends fall off 16-byte boundaries,
// as rows of D = 90 bf16 do); past shared memory its rows stream through a
// ring of 4 stages. Each warp then runs its own online softmax from shared
// memory, in fp32, with no block barrier: a lane group of LPS lanes takes a
// slot, each lane 8 head dims by one 16-byte load (bf16) or two (fp32), four
// slots a group at once with no branch in the loop (slots past the chunk
// read its last row and are dropped); the logits and their max, the exps,
// then the weighted V rows, one rescale a chunk. The warps' states merge in
// a fixed order through shared memory; a cluster's splits push theirs to
// split 0 with one bulk copy each onto its mbarrier, and split 0 merges
// them in split order, so repeats are bit-equal. The barriers are set up
// while kv_len is read. kv_len = 0 gives zeros, as the TPU kernel does.
//
// The fused form (k_new, v_new, write_index not null): slot t =
// clamp(wrap(write_index[b]), 0, Smax - 1) takes the new row, by the rule
// of kv_append (K2). The warp whose run holds t reads the new rows into
// registers as it starts, copies them over its staged K and V rows once
// their barriers complete, and after its reads writes them to the caches;
// if no run holds t (t >= len), warp 0 of split 0 writes them. So each row
// is written once, and no block reads a slot another writes. Rows move as
// raw words.
#include "decode_q8_stage.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kMaxStages = 4;  // a warp's stages: its K and V, or a ring of 4

// The cluster barrier in two halves (every thread of every block arrives,
// then waits), so a block arrives as it starts and waits only at its end.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this block's shared variable p in block `rank` of its cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(mmmm::hop::smem_u32(p)), "r"(rank));
  return a;
}
// One bulk copy of `bytes` from this block's shared memory to another block's
// (cluster address dst), completing on that block's mbarrier; returns once
// the source has been read, so the block may then exit.
__device__ __forceinline__ void push_shared(uint32_t dst, const void* src, uint32_t bytes,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(mmmm::hop::smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// 8 values of a row for lane l of its slot's lane group of LPS lanes: bf16,
// dims [8 l, 8 l + 8); fp32, [4 l, 4 l + 4) and [4 (LPS + l), 4 (LPS + l) + 4),
// so the group's lanes read neighbouring 16-byte pieces. VEC: rows are whole
// 16-byte pieces from 16-byte-aligned addresses; else scalar loads. Zero past
// D where MASK (q); a K or V value past D is left as read, since it meets a
// zero of q or lands in a sum that is never written. Every load's index is
// clamped into the row: ptxas may issue a guarded shared-memory load
// unconditionally, which past the last staged row would leave the block's
// shared memory.
__device__ __forceinline__ int in_row(int d, int D) { return d < D ? d : D - 1; }

template <int LPS>
__device__ __forceinline__ int dim_of(const __nv_bfloat16*, int l, int i) {
  return 8 * l + i;
}
template <int LPS>
__device__ __forceinline__ int dim_of(const float*, int l, int i) {
  return 4 * ((i >> 2) * LPS + l) + (i & 3);
}

template <int LPS, bool VEC, bool MASK>
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int l, int D, float out[8]) {
  const int d0 = 8 * l;
  if constexpr (VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + in_row(d0, D - 7));
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = !MASK || d0 < D ? f.x : 0.f;
      out[2 * i + 1] = !MASK || d0 < D ? f.y : 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = __bfloat162float(row[in_row(d0 + e, D)]);
      out[e] = !MASK || d0 + e < D ? x : 0.f;
    }
  }
}

template <int LPS, bool VEC, bool MASK>
__device__ __forceinline__ void load8(const float* row, int l, int D, float out[8]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d0 = 4 * (c * LPS + l);
    if constexpr (VEC) {
      const float4 raw = *reinterpret_cast<const float4*>(row + in_row(d0, D - 3));
      out[4 * c] = !MASK || d0 < D ? raw.x : 0.f;
      out[4 * c + 1] = !MASK || d0 < D ? raw.y : 0.f;
      out[4 * c + 2] = !MASK || d0 < D ? raw.z : 0.f;
      out[4 * c + 3] = !MASK || d0 < D ? raw.w : 0.f;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = row[in_row(d0 + e, D)];
        out[4 * c + e] = !MASK || d0 + e < D ? x : 0.f;
      }
    }
  }
}

template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { using type = uint16_t; };
template <> struct Raw<float> { using type = uint32_t; };

// A new row held by a warp as raw words, D <= 128: lane l holds dims l,
// l + 32, l + 64, l + 96.
template <typename T>
struct NewRow {
  typename Raw<T>::type w[4];

  __device__ __forceinline__ void load(const T* row, int D, int lane) {
    const auto* src = reinterpret_cast<const typename Raw<T>::type*>(row);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < D) w[i] = src[lane + 32 * i];
  }
  __device__ __forceinline__ void store(T* row, int D, int lane) const {
    auto* dst = reinterpret_cast<typename Raw<T>::type*>(row);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < D) dst[lane + 32 * i] = w[i];
  }
};

// grid (S, B * H), clusters of S blocks along x (none where S = 1), 256
// threads; C, NS: each warp's staged read (ops/decode_kernel.py
// decode_stage_plan), its area of dynamic shared memory warp_bytes(C, NS,
// rb), and after the 8 warps' areas, where S > 1, the S splits' partials
// (part_bytes). k_new, v_new, write_index: all null (the read alone) or the
// fused form's new rows (B, H, 1, D) and (B,) slots.
__host__ __device__ inline size_t warp_bytes(int C, int NS, int rb) {
  return mmmm::q8::round16((size_t)NS * mmmm::q8::rows_bytes(C, rb) + (size_t)8 * C);
}
// A split's partial: the sums over the DP head dims, then m and l (a
// multiple of 16 bytes, as a bulk copy needs).
__host__ __device__ constexpr uint32_t part_bytes(int DP) { return (DP + 4) * sizeof(float); }

template <typename T, int LPS, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_kernel(const T* __restrict__ q, T* kc, T* vc, const int* __restrict__ kv_len,
                   const T* __restrict__ k_new, const T* __restrict__ v_new,
                   const int* __restrict__ write_index, T* __restrict__ out, int H, int Smax,
                   int D, float scale, int C, int NS) {
  constexpr int G = 32 / LPS;  // slots a warp takes at once
  constexpr int DP = 8 * LPS;  // head dims the lane groups cover
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[kWarps][kMaxStages];
  __shared__ float red_m[kWarps];
  __shared__ float red_l[kWarps];
  __shared__ float acc_s[kWarps][DP];
  __shared__ uint64_t merge_bar;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane / LPS;  // slot group of this lane
  const int l = lane % LPS;  // its lane in the group
  float qv[8];
  load8<LPS, VEC, true>(q + (size_t)blockIdx.y * D, l, D, qv);  // q: (B, 1, H, D)
  const int S = gridDim.x;
  const int r = blockIdx.x;  // this block's split
  const int bh = blockIdx.y;
  const int b = bh / H;
  int len = kv_len[b];
  const int rb = D * static_cast<int>(sizeof(T));
  // the splits' partials, gathered in split 0; split r > 0 stages its own
  // in part[0] and pushes it to part[r] of split 0
  float(*part)[DP + 4] =
      reinterpret_cast<float(*)[DP + 4]>(smem + (size_t)kWarps * warp_bytes(C, NS, rb));
  // while kv_len arrives: every warp's barriers; split 0's also takes the
  // other splits' partials
  constexpr uint32_t kPartBytes = part_bytes(DP);
  if (tid == 0) {
    for (int w = 0; w < kWarps; ++w)
      for (int i = 0; i < NS; ++i) mmmm::hop::mbar_init(&bar[w][i], mmmm::q8::kArrivals);
    if (S > 1) {  // other blocks' copies complete on split 0's barrier
      if (r == 0) mmmm::hop::mbar_init(&merge_bar, 1);
      mmmm::hop::fence_barrier_init();
      if (r == 0) mmmm::hop::mbar_expect_tx(&merge_bar, (S - 1) * kPartBytes);
    }
  }
  __syncthreads();
  len = len < 0 ? 0 : (len > Smax ? Smax : len);
  const int per = (len + S - 1) / S;
  const int start = min(len, r * per);
  const int cnt = min(len, start + per) - start;  // this block's run: [start, start + cnt)
  const int per_w = (cnt + kWarps - 1) / kWarps;
  const int w0 = min(cnt, warp * per_w);
  const int nw = min(cnt, w0 + per_w) - w0;  // this warp's: [start + w0, start + w0 + nw)
  int t = -1;  // the appended slot, and whether this warp writes it
  bool writer = false;
  if (k_new != nullptr) {
    t = write_index[b];
    if (t < 0) t += Smax;
    t = t < 0 ? 0 : (t > Smax - 1 ? Smax - 1 : t);
    writer = r == (t < len ? t / per : 0) && warp == (t - start < cnt ? (t - start) / per_w : 0);
  }
  const int tj = t - start - w0;  // t among this warp's slots, if its run holds it
  NewRow<T> kn, vn;  // the new rows, read now by the warp that places them
  if (writer || (tj >= 0 && tj < nw)) {
    kn.load(k_new + (size_t)bh * D, D, lane);
    vn.load(v_new + (size_t)bh * D, D, lane);
  }

  // ---- every warp requests its own rows at once, on barriers of its own --------------
  unsigned char* wsm = smem + (size_t)warp * warp_bytes(C, NS, rb);
  const size_t row0 = ((size_t)bh * Smax + start + w0) * D;
  const mmmm::q8::RowRing ring{wsm, bar[warp], kc + row0, vc + row0, nullptr, nullptr,
                            C, NS, rb, nw, (nw + C - 1) / C, true};
  float* lg = reinterpret_cast<float*>(wsm + (size_t)NS * mmmm::q8::rows_bytes(C, rb));
  float* pw = lg + C;
  for (int i = 0; i < NS && i < ring.items(); ++i) ring.issue(i, lane);
  if (S > 1) cluster_arrive();  // split 0's barrier is ready

  float m = mmmm::kNegInf;
  float lsum = 0.f;  // this lane's share of the warp's exps' sum
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

  for (int c = 0; c < ring.n_chunks; ++c) {
    const int ik = 2 * c, iv = ik + 1;
    const int n = ring.count(ik);
    const int tc = tj - c * C;  // t in this chunk, if it holds t
    // ---- 1. logits of the chunk, and its max ---------------------------------------
    ring.wait(ik);
    const T* krows = ring.rows<T>(ik);
    if (tc >= 0 && tc < n) {  // the new K row in place of the staged one
      kn.store(const_cast<T*>(krows) + (size_t)tc * D, D, lane);
      __syncwarp();
    }
    float mx = mmmm::kNegInf;
    for (int base = 0; base < n; base += 4 * G) {
      float sc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // slots past the chunk read its last row, then drop
        const int j = base + u * G + g;
        float kf[8];
        load8<LPS, VEC, false>(krows + (size_t)(j < n ? j : n - 1) * D, l, D, kf);
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          x0 = fmaf(qv[e], kf[e], x0);
          x1 = fmaf(qv[e + 1], kf[e + 1], x1);
        }
        sc[u] = x0 + x1;
      }
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = base + u * G + g;
        if (j < n) {
          const float x = sc[u] * scale;
          mx = fmaxf(mx, x);
          if (l == 0) lg[j] = x;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    __syncwarp();
    // ---- 2. exps against the warp's running max; one rescale a chunk -------------------
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
    for (int jj = lane; jj < n; jj += 32) {
      const float pj = expf(lg[jj] - m_new);
      pw[jj] = pj;
      ls += pj;
    }
    lsum = lsum * alpha + ls;
    m = m_new;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= alpha;
    __syncwarp();
    if (ik + NS < ring.items()) ring.issue(ik + NS, lane);  // the ring: refill K's stage
    // ---- 3. the weighted value rows -------------------------------------------------
    ring.wait(iv);
    const T* vrows = ring.rows<T>(iv);
    if (tc >= 0 && tc < n) {
      vn.store(const_cast<T*>(vrows) + (size_t)tc * D, D, lane);
      __syncwarp();
    }
#pragma unroll 4
    for (int base = 0; base < n; base += G) {
      const int jj = base + g;
      const int jc = jj < n ? jj : n - 1;
      const float w = jj < n ? pw[jc] : 0.f;
      float vf[8];
      load8<LPS, VEC, false>(vrows + (size_t)jc * D, l, D, vf);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(w, vf[e], acc[e]);
    }
    __syncwarp();
    if (iv + NS < ring.items()) ring.issue(iv + NS, lane);
  }

  // ---- the appended row, once this warp's reads of its run are done ------------------
  if (writer) {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    const size_t dst = ((size_t)bh * Smax + t) * D;
    kn.store(kc + dst, D, lane);
    vn.store(vc + dst, D, lane);
  }

  // ---- merge: the G lane groups of a warp (same head dims), then the warps -----------
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[warp][dim_of<LPS>(q, l, e)] = acc[e];
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = lsum;
  }
  __syncthreads();
  float mb = red_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, red_m[w]);
  float fw[kWarps];
  float lt = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    fw[w] = expf(red_m[w] - mb);
    lt += red_l[w] * fw[w];
  }
  if (S == 1) {
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += acc_s[w][d] * fw[w];
      out[(size_t)bh * D + d] = mmmm::from_f<T>(lt > 0.f ? __fdividef(o, lt) : 0.f);
    }
    return;
  }
  for (int d = tid; d < DP; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += acc_s[w][d] * fw[w];
    part[0][d] = o;
  }
  if (tid == 0) {
    part[0][DP] = mb;
    part[0][DP + 1] = lt;
  }
  __syncthreads();
  cluster_wait();
  // ---- merge the cluster's splits in split 0, in split order ------------------------
  if (r != 0) {
    if (tid == 0) {
      mmmm::q8::fence_proxy_async();
      push_shared(cluster_addr(part[r], 0), part[0], kPartBytes, cluster_addr(&merge_bar, 0));
    }
    return;
  }
  mmmm::hop::mbar_wait(&merge_bar, 0);
  for (int d = tid; d < D; d += kThreads) {
    float m_all = mmmm::kNegInf;
    for (int s = 0; s < S; ++s) m_all = fmaxf(m_all, part[s][DP]);
    float o = 0.f, lall = 0.f;
    for (int s = 0; s < S; ++s) {
      const float f = expf(part[s][DP] - m_all);
      lall += part[s][DP + 1] * f;
      o += part[s][d] * f;
    }
    out[(size_t)bh * D + d] = mmmm::from_f<T>(lall > 0.f ? __fdividef(o, lall) : 0.f);
  }
}

// The lanes a slot's group takes at head dim D (8 head dims a lane).
int lps_of(int D) { return D <= 8 ? 1 : D <= 16 ? 2 : D <= 32 ? 4 : D <= 64 ? 8 : 16; }

// Dynamic shared memory of a launch: each warp's stages and a chunk's
// logits and exps (fp32), then the splits' partials where S > 1.
size_t k1_smem(int C, int NS, int D, int elem, int S) {
  return (size_t)kWarps * warp_bytes(C, NS, D * elem) + (S > 1 ? S * part_bytes(8 * lps_of(D)) : 0);
}

struct Args {
  const void *q;
  void *kc, *vc;
  const int* lens;
  const void *kn, *vn;
  const int* widx;
  void* out;
  int B, H, Smax, D;
  float scale;
  int S, C, NS;
  cudaStream_t st;
};

template <typename T, int LPS, bool VEC>
int launch_lps(const Args& a) {
  auto* kern = decode_attn_kernel<T, LPS, VEC>;
  const size_t smem = k1_smem(a.C, a.NS, a.D, static_cast<int>(sizeof(T)), a.S);
  static size_t allowed = 0;  // this instance's dynamic shared memory limit, as last set
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid(a.S, a.B * a.H);
  const T* q = static_cast<const T*>(a.q);
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  const T* kn = static_cast<const T*>(a.kn);
  const T* vn = static_cast<const T*>(a.vn);
  T* out = static_cast<T*>(a.out);
  if (a.S == 1) {
    kern<<<grid, kThreads, smem, a.st>>>(q, kc, vc, a.lens, kn, vn, a.widx, out, a.H, a.Smax,
                                         a.D, a.scale, a.C, a.NS);
  } else {
    const cudaError_t err =
        mmmm::hop::launch_cluster(kern, grid, dim3(kThreads), smem, a.st, a.S, q, kc, vc, a.lens,
                                  kn, vn, a.widx, out, a.H, a.Smax, a.D, a.scale, a.C, a.NS);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LPS>
int launch_vec(bool vec, const Args& a) {
  return vec ? launch_lps<T, LPS, true>(a) : launch_lps<T, LPS, false>(a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const Args& a) {
  // 16-byte loads: whole 16-byte pieces a row from 16-byte-aligned bases
  const bool vec = (a.D * sizeof(T)) % 16 == 0 && aligned16(a.q) && aligned16(a.kc) &&
                   aligned16(a.vc) && (a.kn == nullptr || (aligned16(a.kn) && aligned16(a.vn)));
  switch (lps_of(a.D)) {
    case 1: return launch_vec<T, 1>(vec, a);
    case 2: return launch_vec<T, 2>(vec, a);
    case 4: return launch_vec<T, 4>(vec, a);
    case 8: return launch_vec<T, 8>(vec, a);
    default: return launch_vec<T, 16>(vec, a);
  }
}

}  // namespace

// q, out: (B, 1, H, D); k_cache, v_cache: (B, H, Smax, D); one dtype, bf16
// or fp32; kv_len (B,) int32; 1 <= D <= 128. k_new, v_new ((B, H, 1, D),
// the caches' dtype) and write_index ((B,) int32): all null for the read
// alone, or the rows the fused form appends first. splits: blocks a head
// (1-8, ops/decode_kernel.py decode_splits); chunk, stages: each of a
// block's 8 warps' staged read (decode_stage_plan).
extern "C" int mmmm_decode_attention(const void* q, void* k_cache, void* v_cache,
                                     const void* kv_len, const void* k_new, const void* v_new,
                                     const void* write_index, void* out, int B, int H, int Smax,
                                     int D, float scale, int is_bf16, int splits, int chunk,
                                     int stages, void* stream) {
  const bool fused = k_new != nullptr;
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || D > 128 || splits < 1 ||
      splits > kMaxSplits || chunk < 1 || stages < 2 || stages > kMaxStages ||
      fused != (v_new != nullptr) || fused != (write_index != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, static_cast<const int*>(kv_len), k_new, v_new,
               static_cast<const int*>(write_index), out, B, H, Smax, D, scale, splits, chunk,
               stages, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

// The dynamic shared memory K1 asks for under a plan.
extern "C" int mmmm_decode_attention_smem(int chunk, int stages, int D, int elem_bytes,
                                          int splits) {
  return static_cast<int>(k1_smem(chunk, stages, D, elem_bytes, splits));
}
