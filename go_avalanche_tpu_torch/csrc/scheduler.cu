// The streaming scheduler's two passes over the [N, W] window for Hopper
// (sm_90a): the settle scan (which set-slots still hold a pollable
// record, and how many rows finalized each column accepted), then the
// out-of-place refill of the window's five planes.
//
// Replaces no TPU kernel: the JAX package's scheduler
// (go_avalanche_tpu/models/streaming_dag.py, `_retire_and_refill`) is
// plain XLA.  Added because the port's plain scheduler made about ten
// full-window passes a step (two int16 -> int32 widenings for the two
// finality tests, `any`, `repeat_interleave`, a five-way `&`, a `sum`,
// a `torch.where` a plane), ~12x the byte bound below.  Plain versions,
// and the oracles these kernels are held against on the card:
//  - `settle_scan_kernel`: models/streaming_dag.py::settle_scan_plain;
//  - `refill_kernel`: models/streaming_dag.py::refill_plain.
//
// Bound.  settle_scan reads each record's 2 B confidence and 1 B `added`
// once (the [N] and [W] masks are noise): 0.61 GB, 0.18 ms at the
// stream's 100000 x 2048 at 3.35 TB/s.  refill reads and writes 9 B a
// record each way (votes 1, consider 1, confidence 2, added 1,
// finalized_at 4; 5 B with finality tracking off): 3.69 GB, 1.10 ms.
//
// Design.  One thread per 8 columns of a row, walking rows: columns
// across x, rows split over y so that one wave fills the card, each
// thread a few rows' loads ahead.  The fast path (W % 8 == 0, aligned
// planes) moves a thread's 8 columns of a plane as one 8- or 16-byte
// streaming load or store; the general path (any W, any alignment) reads
// and writes lane by lane, with the same arithmetic.
//  - settle_scan<C>: 8 u16 confidence words in registers; a counter
//    reaches the score when the word is >= 2 * score, so no widened
//    plane.  Sets of C lanes, 8 % C == 0, so a thread holds whole sets
//    and a set's "some row finalized it accepted" stays in registers.
//    The thread ORs its rows' pending bits and counts each column's
//    finalized-accepted added rows, then writes a 1 into each pending
//    set's byte (every writer stores the same value) and adds each
//    count with one atomic, into outputs the wrapper zeroed.
//  - refill: the taken, occupied-after and fresh-preference columns
//    become byte, half-word and word masks once a thread; a row is then
//    a few logical operations a plane.
// No shared memory and no synchronisation.  Neither kernel allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanRows = 4;     // rows a settle_scan thread loads ahead
constexpr int kRefillRows = 2;   // rows a refill thread loads ahead

// Byte m (m < 4 from .x) of an 8-byte chunk; half-word m of a 16-byte one.
__device__ __forceinline__ uint32_t byte_of(const uint2& v, int m) {
  return ((m < 4 ? v.x : v.y) >> (8 * (m & 3))) & 0xFFu;
}

__device__ __forceinline__ uint32_t half_of(const uint4& v, int m) {
  const uint32_t w = m < 2 ? v.x : m < 4 ? v.y : m < 6 ? v.z : v.w;
  return (w >> (16 * (m & 1))) & 0xFFFFu;
}

// ---- settle_scan -----------------------------------------------------

struct ScanArgs {
  const uint16_t* conf;   // [n, w] confidence words (int16 storage, u16)
  const uint8_t* added;   // [n, w] bool
  const uint8_t* alive;   // [n] bool
  const uint8_t* valid;   // [w] bool
  uint8_t* pending;       // [w / c] bool, zeroed: the set has a pollable record
  int32_t* accept;        // [w], zeroed: rows finalized accepted and added
  int n, w, w8;
  uint32_t threshold;     // 2 * finalization score, clamped to [0, 0x10000]
};

template <bool VEC>
__device__ __forceinline__ void scan_load(const ScanArgs& a, int r, int b,
                                          int cols, uint4& conf,
                                          uint2& added) {
  const size_t off = static_cast<size_t>(r) * a.w + 8 * b;
  if constexpr (VEC) {
    conf = __ldcs(reinterpret_cast<const uint4*>(a.conf + off));
    added = __ldcs(reinterpret_cast<const uint2*>(a.added + off));
  } else {
    uint32_t c[4] = {0u, 0u, 0u, 0u};
    uint32_t d[2] = {0u, 0u};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (m < cols) {
        c[m >> 1] |= static_cast<uint32_t>(__ldg(a.conf + off + m))
                     << (16 * (m & 1));
        d[m >> 2] |= static_cast<uint32_t>(__ldg(a.added + off + m))
                     << (8 * (m & 3));
      }
    }
    conf = make_uint4(c[0], c[1], c[2], c[3]);
    added = make_uint2(d[0], d[1]);
  }
}

// Each set of C lanes of `bits` to all ones where any of its lanes is set.
template <int C>
__device__ __forceinline__ uint32_t spread_sets(uint32_t bits) {
  constexpr uint32_t lanes = (1u << C) - 1u;
  uint32_t out = 0u;
#pragma unroll
  for (int g = 0; g < 8; g += C) {
    if ((bits >> g) & lanes) out |= lanes << g;
  }
  return out;
}

template <int C, bool VEC>
__global__ void __launch_bounds__(kThreads) settle_scan_kernel(ScanArgs a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;   // 8-column chunk
  if (b >= a.w8) return;
  const int cols = a.w - 8 * b < 8 ? a.w - 8 * b : 8;
  const uint32_t in_row = (1u << cols) - 1u;
  uint32_t valid = 0u;
  for (int m = 0; m < cols; ++m) {
    valid |= (__ldg(a.valid + 8 * b + m) != 0 ? 1u : 0u) << m;
  }
  uint32_t pending = 0u;
  int count[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const int stride = static_cast<int>(gridDim.y);
  for (int r0 = blockIdx.y; r0 < a.n; r0 += kScanRows * stride) {
    uint4 conf[kScanRows];
    uint2 added[kScanRows];
#pragma unroll
    for (int i = 0; i < kScanRows; ++i) {
      const int r = r0 + i * stride;
      if (r < a.n) {
        scan_load<VEC>(a, r, b, cols, conf[i], added[i]);
      } else {
        conf[i] = make_uint4(0u, 0u, 0u, 0u);
        added[i] = make_uint2(0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < kScanRows; ++i) {
      const int r = r0 + i * stride;
      if (r >= a.n) break;
      uint32_t fin = 0u, acc = 0u, add = 0u;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const uint32_t x = half_of(conf[i], m);
        fin |= (x >= a.threshold ? 1u : 0u) << m;
        acc |= (x & 1u) << m;
        add |= (byte_of(added[i], m) != 0u ? 1u : 0u) << m;
      }
      fin &= in_row;           // the general path's padding lanes
      const uint32_t fin_acc = fin & acc;
      const uint32_t live = __ldg(a.alive + r) != 0 ? 0xFFu : 0u;
      pending |= add & live & valid & ~fin & ~spread_sets<C>(fin_acc);
      const uint32_t votes = fin_acc & add;
#pragma unroll
      for (int m = 0; m < 8; ++m) count[m] += (votes >> m) & 1u;
    }
  }
  // Padding lanes have no `added` and no `valid` bit: nothing past w.
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    if (count[m] != 0) atomicAdd(a.accept + 8 * b + m, count[m]);
  }
#pragma unroll
  for (int g = 0; g < 8; g += C) {
    if ((pending >> g) & ((1u << C) - 1u)) a.pending[(8 * b + g) / C] = 1;
  }
}

// ---- refill ----------------------------------------------------------

struct RefillArgs {
  const uint8_t* votes;      // [n, w]
  const uint8_t* consider;   // [n, w]
  const uint16_t* conf;      // [n, w] confidence words
  const uint8_t* added;      // [n, w] bool
  const int32_t* fin_at;     // [n, w] finalization stamps (FIN only)
  const uint8_t* take;       // [w] bool: the column seeds a fresh record
  const uint8_t* occupied;   // [w] bool: the column's slot is occupied after
  const uint8_t* pref;       // [w] bool: a fresh record's preference
  uint8_t* votes_out;
  uint8_t* consider_out;
  uint16_t* conf_out;
  uint8_t* added_out;
  int32_t* fin_at_out;
  int n, w, w8;
};

// A thread's 8 columns of one row, every plane.
struct Chunk {
  uint2 votes, consider, added;
  uint4 conf, fin_lo, fin_hi;
};

template <bool VEC, bool FIN>
__device__ __forceinline__ Chunk refill_load(const RefillArgs& a, size_t off,
                                             int cols) {
  Chunk c;
  if constexpr (VEC) {
    c.votes = __ldcs(reinterpret_cast<const uint2*>(a.votes + off));
    c.consider = __ldcs(reinterpret_cast<const uint2*>(a.consider + off));
    c.added = __ldcs(reinterpret_cast<const uint2*>(a.added + off));
    c.conf = __ldcs(reinterpret_cast<const uint4*>(a.conf + off));
    if constexpr (FIN) {
      c.fin_lo = __ldcs(reinterpret_cast<const uint4*>(a.fin_at + off));
      c.fin_hi = __ldcs(reinterpret_cast<const uint4*>(a.fin_at + off + 4));
    }
  } else {
    uint32_t v[2] = {0u, 0u}, s[2] = {0u, 0u}, d[2] = {0u, 0u};
    uint32_t h[4] = {0u, 0u, 0u, 0u};
    uint32_t f[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (m < cols) {
        const int sh = 8 * (m & 3);
        v[m >> 2] |= static_cast<uint32_t>(__ldg(a.votes + off + m)) << sh;
        s[m >> 2] |= static_cast<uint32_t>(__ldg(a.consider + off + m)) << sh;
        d[m >> 2] |= static_cast<uint32_t>(__ldg(a.added + off + m)) << sh;
        h[m >> 1] |= static_cast<uint32_t>(__ldg(a.conf + off + m))
                     << (16 * (m & 1));
        if constexpr (FIN) {
          f[m] = static_cast<uint32_t>(__ldg(a.fin_at + off + m));
        }
      }
    }
    c.votes = make_uint2(v[0], v[1]);
    c.consider = make_uint2(s[0], s[1]);
    c.added = make_uint2(d[0], d[1]);
    c.conf = make_uint4(h[0], h[1], h[2], h[3]);
    c.fin_lo = make_uint4(f[0], f[1], f[2], f[3]);
    c.fin_hi = make_uint4(f[4], f[5], f[6], f[7]);
  }
  return c;
}

__device__ __forceinline__ uint32_t word_of(const Chunk& c, int m) {
  const uint4& q = m < 4 ? c.fin_lo : c.fin_hi;
  const int k = m & 3;
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

template <bool VEC, bool FIN>
__device__ __forceinline__ void refill_store(const RefillArgs& a, size_t off,
                                             int cols, const Chunk& c) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<uint2*>(a.votes_out + off), c.votes);
    __stcs(reinterpret_cast<uint2*>(a.consider_out + off), c.consider);
    __stcs(reinterpret_cast<uint2*>(a.added_out + off), c.added);
    __stcs(reinterpret_cast<uint4*>(a.conf_out + off), c.conf);
    if constexpr (FIN) {
      __stcs(reinterpret_cast<uint4*>(a.fin_at_out + off), c.fin_lo);
      __stcs(reinterpret_cast<uint4*>(a.fin_at_out + off + 4), c.fin_hi);
    }
  } else {
    for (int m = 0; m < cols; ++m) {
      a.votes_out[off + m] = static_cast<uint8_t>(byte_of(c.votes, m));
      a.consider_out[off + m] = static_cast<uint8_t>(byte_of(c.consider, m));
      a.added_out[off + m] = static_cast<uint8_t>(byte_of(c.added, m));
      a.conf_out[off + m] = static_cast<uint16_t>(half_of(c.conf, m));
      if constexpr (FIN) {
        a.fin_at_out[off + m] = static_cast<int32_t>(word_of(c, m));
      }
    }
  }
}

__device__ __forceinline__ uint4 or4(const uint4& x, const uint4& y) {
  return make_uint4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
}

template <bool VEC, bool FIN>
__global__ void __launch_bounds__(kThreads) refill_kernel(RefillArgs a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;   // 8-column chunk
  if (b >= a.w8) return;
  const int cols = a.w - 8 * b < 8 ? a.w - 8 * b : 8;
  // Column masks: `keep` bytes / halves 0xFF.. where the column is not
  // taken, `occ` bytes 0xFF where its slot stays occupied, `one` bytes
  // 0x01 and `fresh` halves the preference where it is taken, `reset`
  // words all ones (the stamp -1) where it is taken.
  uint32_t keep[2] = {0u, 0u}, occ[2] = {0u, 0u}, one[2] = {0u, 0u};
  uint32_t keep_h[4] = {0u, 0u, 0u, 0u}, fresh[4] = {0u, 0u, 0u, 0u};
  uint32_t reset[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    if (m < cols) {
      const int col = 8 * b + m;
      const bool take = __ldg(a.take + col) != 0;
      const int sb = 8 * (m & 3), sh = 16 * (m & 1);
      if (take) {
        one[m >> 2] |= 1u << sb;
        fresh[m >> 1] |= (__ldg(a.pref + col) != 0 ? 1u : 0u) << sh;
        reset[m] = 0xFFFFFFFFu;
      } else {
        keep[m >> 2] |= 0xFFu << sb;
        keep_h[m >> 1] |= 0xFFFFu << sh;
      }
      if (__ldg(a.occupied + col) != 0) occ[m >> 2] |= 0xFFu << sb;
    }
  }
  const uint4 reset_lo = make_uint4(reset[0], reset[1], reset[2], reset[3]);
  const uint4 reset_hi = make_uint4(reset[4], reset[5], reset[6], reset[7]);
  const int stride = static_cast<int>(gridDim.y);
  for (int r0 = blockIdx.y; r0 < a.n; r0 += kRefillRows * stride) {
    Chunk c[kRefillRows];
#pragma unroll
    for (int i = 0; i < kRefillRows; ++i) {
      const int r = r0 + i * stride;
      if (r < a.n) {
        c[i] = refill_load<VEC, FIN>(
            a, static_cast<size_t>(r) * a.w + 8 * b, cols);
      }
    }
#pragma unroll
    for (int i = 0; i < kRefillRows; ++i) {
      const int r = r0 + i * stride;
      if (r >= a.n) break;
      Chunk& x = c[i];
      x.votes = make_uint2(x.votes.x & keep[0], x.votes.y & keep[1]);
      x.consider = make_uint2(x.consider.x & keep[0],
                              x.consider.y & keep[1]);
      x.added = make_uint2((x.added.x & occ[0]) | one[0],
                           (x.added.y & occ[1]) | one[1]);
      x.conf = make_uint4((x.conf.x & keep_h[0]) | fresh[0],
                          (x.conf.y & keep_h[1]) | fresh[1],
                          (x.conf.z & keep_h[2]) | fresh[2],
                          (x.conf.w & keep_h[3]) | fresh[3]);
      if constexpr (FIN) {
        x.fin_lo = or4(x.fin_lo, reset_lo);
        x.fin_hi = or4(x.fin_hi, reset_hi);
      }
      refill_store<VEC, FIN>(a, static_cast<size_t>(r) * a.w + 8 * b, cols,
                             x);
    }
  }
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

// Chunks across x; rows split over y so that one wave fills the card and
// each thread walks n / gridDim.y rows.
template <typename Args>
void launch_rows(void (*kernel)(Args), const Args& a, cudaStream_t s) {
  const int bx = (a.w8 + kThreads - 1) / kThreads;
  int by = resident_blocks(reinterpret_cast<const void*>(kernel)) / bx;
  by = by < 1 ? 1 : (by > a.n ? a.n : by);
  by = by > 65535 ? 65535 : by;
  kernel<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)),
           kThreads, 0, s>>>(a);
}

template <int C>
void launch_scan(const ScanArgs& a, bool vec, cudaStream_t s) {
  void (*kernel)(ScanArgs) = settle_scan_kernel<C, false>;
  if (vec) kernel = settle_scan_kernel<C, true>;
  launch_rows(kernel, a, s);
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

// Scan the [n, w] window of sets of `c` lanes (8 % c == 0, w % c == 0):
// `pending` ([w / c] bool, zeroed) gets a 1 where some live node's added
// record of a valid column is unfinalized and no member of its set
// finalized accepted at that node; `accept` ([w] int32, zeroed) gets, per
// column, the rows whose added record finalized accepted.  A counter
// has finalized at `score` or more.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int settle_scan(const void* conf, const void* added,
                           const void* alive, const void* valid,
                           void* pending, void* accept, int n, int w, int c,
                           int score, void* stream) {
  if (n <= 0 || w <= 0 || c <= 0 || 8 % c != 0 || w % c != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScanArgs a;
  a.conf = static_cast<const uint16_t*>(conf);
  a.added = static_cast<const uint8_t*>(added);
  a.alive = static_cast<const uint8_t*>(alive);
  a.valid = static_cast<const uint8_t*>(valid);
  a.pending = static_cast<uint8_t*>(pending);
  a.accept = static_cast<int32_t*>(accept);
  a.n = n;
  a.w = w;
  a.w8 = (w + 7) / 8;
  const int clamped = score < 0 ? 0 : (score > 0x8000 ? 0x8000 : score);
  a.threshold = 2u * static_cast<uint32_t>(clamped);
  const bool vec = w % 8 == 0 && aligned(conf, 16) && aligned(added, 8);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch_scan<1>(a, vec, s); break;
    case 2: launch_scan<2>(a, vec, s); break;
    case 4: launch_scan<4>(a, vec, s); break;
    default: launch_scan<8>(a, vec, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Write the refilled window: at each `take` column votes and consider 0,
// confidence the column's `pref`, added 1 and the stamp -1; elsewhere
// the old values, with added cleared where the slot is not `occupied`
// after.  `fin_at` and `fin_at_out` are both null with finality tracking
// off.  Launches on `stream`; returns cudaGetLastError().
extern "C" int refill(const void* votes, const void* consider,
                      const void* conf, const void* added, const void* fin_at,
                      const void* take, const void* occupied,
                      const void* pref, void* votes_out, void* consider_out,
                      void* conf_out, void* added_out, void* fin_at_out,
                      int n, int w, void* stream) {
  if (n <= 0 || w <= 0 || (fin_at == nullptr) != (fin_at_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RefillArgs a;
  a.votes = static_cast<const uint8_t*>(votes);
  a.consider = static_cast<const uint8_t*>(consider);
  a.conf = static_cast<const uint16_t*>(conf);
  a.added = static_cast<const uint8_t*>(added);
  a.fin_at = static_cast<const int32_t*>(fin_at);
  a.take = static_cast<const uint8_t*>(take);
  a.occupied = static_cast<const uint8_t*>(occupied);
  a.pref = static_cast<const uint8_t*>(pref);
  a.votes_out = static_cast<uint8_t*>(votes_out);
  a.consider_out = static_cast<uint8_t*>(consider_out);
  a.conf_out = static_cast<uint16_t*>(conf_out);
  a.added_out = static_cast<uint8_t*>(added_out);
  a.fin_at_out = static_cast<int32_t*>(fin_at_out);
  a.n = n;
  a.w = w;
  a.w8 = (w + 7) / 8;
  const bool fin = fin_at != nullptr;
  const bool vec = w % 8 == 0 && aligned(votes, 8) && aligned(consider, 8)
                   && aligned(added, 8) && aligned(conf, 16)
                   && aligned(votes_out, 8) && aligned(consider_out, 8)
                   && aligned(added_out, 8) && aligned(conf_out, 16)
                   && (!fin || (aligned(fin_at, 16) && aligned(fin_at_out, 16)));
  void (*kernel)(RefillArgs) = refill_kernel<false, false>;
  if (vec) {
    kernel = fin ? refill_kernel<true, true> : refill_kernel<true, false>;
  } else if (fin) {
    kernel = refill_kernel<false, true>;
  }
  launch_rows(kernel, a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
