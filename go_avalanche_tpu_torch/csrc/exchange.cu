// The peer exchange for Hopper (sm_90a): the packed preferred-in-set
// plane of a DAG round, then the k-draw vote packs gathered from it.
//
// Replaces no TPU kernel: the JAX package's exchange
// (go_avalanche_tpu/models/dag.py, go_avalanche_tpu/ops/exchange.py) is
// plain XLA.  Added because the port's plain PyTorch exchange ran about
// 90 launches a round over full planes (an int32 [N, T] widening, an
// int64 argmax, a bool [N, k, T] vote cube and 24 strided packing
// passes), ~100x the byte bound below.  Plain versions, and the oracles
// these kernels are held against on the card:
//  - `prefs_pack_kernel` / `prefs_pack_kernel_any`:
//    ops/bitops.py::pack_bool_plane of
//    models/dag.py::preferred_in_set_fixed, and, with counts,
//    ops/adversary.py::minority_plane of the same plane;
//  - `vote_packs_kernel`: ops/exchange.py::fused_vote_packs under FLIP
//    and OPPOSE_MAJORITY.
//
// Bound.  prefs_pack reads the int16 confidence once (2 B a record) and
// writes one bit a record; vote_packs gathers k packed rows (k bits a
// record, from a plane that fits the 50 MB L2) and writes the uint8
// yes pack (1 B a record).  About 3.1 B a record from device memory:
// 0.19 ms at the stream's 100000 x 2048, 0.09 ms at the DAG's
// 10000 x 10000, at 3.35 TB/s.
//
// Design.
//  - prefs_pack: one thread per output byte (8 tx columns) of a row,
//    walking rows; the fast path (T % 8 == 0, a set size dividing 8,
//    16-byte aligned confidence) reads the 8 words as one 16-byte
//    streaming load and compares them as u16 in registers, ties to the
//    lowest lane, with no widened plane.  A thread keeps rows
//    `kRowsInFlight` loads ahead.  Under OPPOSE_MAJORITY (COUNT) the
//    thread also counts its columns' preferred rows in registers and
//    adds them to the [T] counts with one atomic per column at its end,
//    so the minority colours cost no second pass over the plane.  The
//    general path (any set size, any T, any alignment) scans every set
//    that meets the thread's byte word by word.
//  - vote_packs: one thread per (querier row, 8-tx byte): k byte
//    gathers of the peers' packed rows (neighbouring threads read
//    neighbouring bytes of one peer row), the lie applied to the whole
//    byte (FLIP: xor; OPPOSE: the minority colours, read as bools and
//    packed in registers), then the k x 8 bit block transposed in
//    registers (three delta swaps) into the 8 bytes of `yes_pack`
//    (bit j = draw j), stored as one 8-byte streaming
//    store where T % 8 == 0.  The thread of byte 0 also writes the
//    row's consider byte (bit j = draw j responded).  The same gather
//    and lie as csrc/megakernel.cu's, at byte granularity, since a DAG
//    row (T / 8 = 1250 B) need not hold whole 16-bit words.
// Measured (NVIDIA H100 80GB HBM3, 700 W; k = 8, sets of 2; device time,
// chip_smoke.py phase 6): prefs_pack 0.147 ms at 100000 x 2048 and
// 0.079 ms at 10000 x 10000 under FLIP, 81-88% of its byte bound (0.209
// and 0.092 ms with OPPOSE's counts); vote_packs 0.223 and 0.093 ms
// under FLIP, 0.253 and 0.122 ms under OPPOSE, 28-36% of its bound,
// likely held by latency: a thread's peer-id loads, then 8 dependent
// byte gathers (more bytes a thread would amortise them).  The plain
// versions took 24.4 ms (stream) and 12.4 ms (DAG) for both.
// No shared memory and no synchronisation; atomics only for the OPPOSE
// counts.  Neither kernel allocates anything.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsInFlight = 4;   // rows a prefs_pack thread loads ahead

// ---- prefs_pack ------------------------------------------------------

struct PackArgs {
  const uint16_t* conf;  // [n, t] confidence words (int16 storage, u16 order)
  uint8_t* packed;       // [n, t8]: bit j of byte b = tx 8b + j preferred
  int32_t* counts;       // [t] preferred rows per tx (COUNT only)
  int n, t, t8, c;
};

// Eight u16 words (tx 8b .. 8b+7) -> their preferred bits for sets of C
// lanes, 8 % C == 0: the lane holding the set's largest word, ties to
// the lowest lane (torch.argmax's first maximum).
template <int C>
__device__ __forceinline__ uint32_t pref_byte(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t x[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = w[i] & 0xFFFFu;
    x[2 * i + 1] = w[i] >> 16;
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int g = 0; g < 8; g += C) {
    int best = g;
    uint32_t top = x[g];
#pragma unroll
    for (int l = g + 1; l < g + C; ++l) {
      if (x[l] > top) {
        top = x[l];
        best = l;
      }
    }
    bits |= 1u << best;
  }
  return bits;
}

template <bool COUNT>
__device__ __forceinline__ void add_counts(const PackArgs& a, int b,
                                           const int (&count)[8]) {
  if constexpr (COUNT) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (count[j] != 0 && 8 * b + j < a.t) {
        atomicAdd(a.counts + 8 * b + j, count[j]);
      }
    }
  }
}

template <int C, bool COUNT>
__global__ void __launch_bounds__(kThreads) prefs_pack_kernel(PackArgs a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;   // byte of the row
  if (b >= a.t8) return;
  const uint4* conf = reinterpret_cast<const uint4*>(a.conf);
  const int stride = static_cast<int>(gridDim.y);
  int count[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int r0 = blockIdx.y; r0 < a.n; r0 += kRowsInFlight * stride) {
    uint4 v[kRowsInFlight];
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) {
      const int r = r0 + i * stride;
      v[i] = r < a.n ? __ldcs(conf + static_cast<size_t>(r) * a.t8 + b)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) {
      const int r = r0 + i * stride;
      if (r >= a.n) break;
      const uint32_t bits = pref_byte<C>(v[i]);
      a.packed[static_cast<size_t>(r) * a.t8 + b] =
          static_cast<uint8_t>(bits);
      if constexpr (COUNT) {
#pragma unroll
        for (int j = 0; j < 8; ++j) count[j] += (bits >> j) & 1u;
      }
    }
  }
  add_counts<COUNT>(a, b, count);
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads) prefs_pack_kernel_any(PackArgs a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.t8) return;
  const int lo = 8 * b;
  const int hi = min(lo + 8, a.t);
  int count[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int r = blockIdx.y; r < a.n; r += gridDim.y) {
    const uint16_t* row = a.conf + static_cast<size_t>(r) * a.t;
    uint32_t bits = 0u;
    // Every set that meets columns [lo, hi): its best member, if here.
    for (int s0 = lo - lo % a.c; s0 < hi; s0 += a.c) {
      int best = s0;
      uint32_t top = __ldg(row + s0);
      for (int m = s0 + 1; m < s0 + a.c; ++m) {
        const uint32_t x = __ldg(row + m);
        if (x > top) {
          top = x;
          best = m;
        }
      }
      if (best >= lo && best < hi) bits |= 1u << (best - lo);
    }
    a.packed[static_cast<size_t>(r) * a.t8 + b] = static_cast<uint8_t>(bits);
    if constexpr (COUNT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) count[j] += (bits >> j) & 1u;
    }
  }
  add_counts<COUNT>(a, b, count);
}

// Blocks of `kernel` the whole card holds at once.
int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <bool COUNT>
void launch_pack(const PackArgs& a, bool fast, cudaStream_t s) {
  void (*kernel)(PackArgs) = prefs_pack_kernel_any<COUNT>;
  if (fast) {
    switch (a.c) {
      case 1: kernel = prefs_pack_kernel<1, COUNT>; break;
      case 2: kernel = prefs_pack_kernel<2, COUNT>; break;
      case 4: kernel = prefs_pack_kernel<4, COUNT>; break;
      default: kernel = prefs_pack_kernel<8, COUNT>; break;
    }
  }
  // Columns across x; rows split over y so that one wave fills the card
  // and each thread walks n / gridDim.y rows.
  const int bx = (a.t8 + kThreads - 1) / kThreads;
  int by = resident_blocks(reinterpret_cast<const void*>(kernel)) / bx;
  by = by < 1 ? 1 : (by > a.n ? a.n : by);
  kernel<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)),
           kThreads, 0, s>>>(a);
}

// ---- vote_packs ------------------------------------------------------

struct VoteArgs {
  const uint8_t* packed;     // [n_src, t8] packed preferences
  const int32_t* peers;      // [n, k] peer rows
  const uint8_t* responded;  // [n, k] bool
  const uint8_t* lie;        // [n, k] bool
  const uint8_t* minority;   // [t] bool minority colours (OPPOSE)
  uint8_t* yes;              // [n, t]: bit j = draw j's (lied) vote
  uint8_t* consider;         // [n]: bit j = draw j responded
  int n_src, t, t8;
  bool wide;                 // t % 8 == 0 and `yes` 8-byte aligned
};

// An 8 x 8 bit matrix, row j in byte j (bit m = column m), to its
// transpose (byte m, bit j), by three delta swaps.
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t s = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= s ^ (s << 7);
  s = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= s ^ (s << 14);
  s = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= s ^ (s << 28);
  return x;
}

template <int K, bool OPPOSE>
__global__ void __launch_bounds__(kThreads) vote_packs_kernel(VoteArgs a) {
  const int row = blockIdx.x;
  const int b = blockIdx.y * kThreads + threadIdx.x;   // byte of the row
  const size_t rk = static_cast<size_t>(row) * K;
  if (b == 0) {
    uint32_t cons = 0u;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      cons |= (__ldg(a.responded + rk + j) != 0 ? 1u : 0u) << j;
    }
    a.consider[row] = static_cast<uint8_t>(cons);
  }
  if (b >= a.t8) return;
  const int cols = a.t - 8 * b < 8 ? a.t - 8 * b : 8;
  uint32_t minority = 0u;   // the byte's colours, packed as the votes are
  if constexpr (OPPOSE) {
    for (int m = 0; m < cols; ++m) {
      minority |= (__ldg(a.minority + 8 * b + m) != 0 ? 1u : 0u) << m;
    }
  }
  uint64_t x = 0u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    // Peer ids come from the round's draw, in [0, n_src) by construction.
    const int p = __ldg(a.peers + rk + j);
    uint32_t g = __ldg(a.packed + static_cast<size_t>(p) * a.t8 + b);
    const bool lies = __ldg(a.lie + rk + j) != 0;
    if constexpr (OPPOSE) {      // a lie says the minority colour
      g = lies ? minority : g;
    } else {                     // FLIP: a lie says the opposite
      g ^= lies ? 0xFFu : 0u;
    }
    x |= static_cast<uint64_t>(g) << (8 * j);
  }
  x = transpose8(x);
  uint8_t* out = a.yes + static_cast<size_t>(row) * a.t + 8 * b;
  if (a.wide && cols == 8) {
    __stcs(reinterpret_cast<unsigned long long*>(out),
           static_cast<unsigned long long>(x));
  } else {
    for (int m = 0; m < cols; ++m) {
      out[m] = static_cast<uint8_t>(x >> (8 * m));
    }
  }
}

template <int K>
void launch_votes(const VoteArgs& a, bool oppose, dim3 grid, cudaStream_t s) {
  if (oppose) {
    vote_packs_kernel<K, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    vote_packs_kernel<K, false><<<grid, kThreads, 0, s>>>(a);
  }
}

}  // namespace

// Pack the preferred-in-set plane of the contiguous partition into
// `c`-tx sets; with `counts` (zeroed [t] int32) also add each tx's
// preferred rows to it.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int prefs_pack(const void* conf, void* packed, void* counts,
                          int n, int t, int c, void* stream) {
  if (n <= 0 || t <= 0 || c <= 0 || t % c != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackArgs a;
  a.conf = static_cast<const uint16_t*>(conf);
  a.packed = static_cast<uint8_t*>(packed);
  a.counts = static_cast<int32_t*>(counts);
  a.n = n;
  a.t = t;
  a.t8 = (t + 7) / 8;
  a.c = c;
  const bool fast = t % 8 == 0 && 8 % c == 0
                    && reinterpret_cast<uintptr_t>(conf) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts != nullptr) {
    launch_pack<true>(a, fast, s);
  } else {
    launch_pack<false>(a, fast, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Gather the k draws of each of the `n` querier rows from the
// `n_src`-row packed plane into `yes` [n, t] and `consider` [n];
// `oppose` substitutes the `minority` colours ([t] bool) for a lie, else
// a lie flips the byte.  Launches on `stream`; returns cudaGetLastError().
extern "C" int vote_packs(const void* packed, const void* peers,
                          const void* responded, const void* lie,
                          const void* minority, void* yes, void* consider,
                          int n, int n_src, int t, int k, int oppose,
                          void* stream) {
  if (n <= 0 || n_src <= 0 || t <= 0 || k <= 0 || k > 8
      || (oppose != 0 && minority == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  VoteArgs a;
  a.packed = static_cast<const uint8_t*>(packed);
  a.peers = static_cast<const int32_t*>(peers);
  a.responded = static_cast<const uint8_t*>(responded);
  a.lie = static_cast<const uint8_t*>(lie);
  a.minority = static_cast<const uint8_t*>(minority);
  a.yes = static_cast<uint8_t*>(yes);
  a.consider = static_cast<uint8_t*>(consider);
  a.n_src = n_src;
  a.t = t;
  a.t8 = (t + 7) / 8;
  a.wide = t % 8 == 0 && reinterpret_cast<uintptr_t>(yes) % 8 == 0;
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((a.t8 + kThreads - 1) / kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool opp = oppose != 0;
  switch (k) {
    case 1: launch_votes<1>(a, opp, grid, s); break;
    case 2: launch_votes<2>(a, opp, grid, s); break;
    case 3: launch_votes<3>(a, opp, grid, s); break;
    case 4: launch_votes<4>(a, opp, grid, s); break;
    case 5: launch_votes<5>(a, opp, grid, s); break;
    case 6: launch_votes<6>(a, opp, grid, s); break;
    case 7: launch_votes<7>(a, opp, grid, s); break;
    default: launch_votes<8>(a, opp, grid, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
