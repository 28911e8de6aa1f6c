// CPU emulation of the CUDA yama kernel (multiz_jax/ops/cuda/yama_dp.cuh)
// for tests: each problem runs on 32 threads, one per lane, and the warp
// primitives are built from a barrier, so the kernel's own source is
// exercised without a GPU. Same operand layout as the FFI handler in
// yama_dp.cu. Build: g++ -O1 -std=c++20 -shared -fPIC -pthread
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>

#include "yama_dp.cuh"

namespace {

struct EmuWarp {
  int ln;
  std::barrier<>* bar;
  int32_t* slots;  // 32 exchange slots shared by the warp
  int lane() const { return ln; }
  int32_t exchange(int32_t v, int src) const {
    slots[ln] = v;
    bar->arrive_and_wait();
    const int32_t r = slots[src];
    bar->arrive_and_wait();
    return r;
  }
  int32_t shfl_up(int32_t v, int d) const {
    const int32_t r = exchange(v, ln >= d ? ln - d : ln);
    return ln >= d ? r : v;
  }
  int32_t shfl(int32_t v, int src) const { return exchange(v, src); }
  void sync() const { bar->arrive_and_wait(); }
};

}  // namespace

extern "C" int mz_yama_dp_emu(const int32_t* cstat, const int32_t* rstat,
                              const int32_t* mnkl, uint8_t* out,
                              uint8_t* flags, int B, int nrow, int ncol,
                              int outw, int wcap, int32_t go, int32_t ge) {
  std::vector<int32_t> ring(6 * (size_t)wcap);
  int32_t slots[32];
  for (int b = 0; b < B; ++b) {
    mzdp::Problem p;
    p.cstat = cstat + (size_t)b * mzdp::NCSTAT * ncol;
    p.rstat = rstat + (size_t)b * nrow * mzdp::NRSTAT;
    p.flags = flags + (size_t)b * nrow * wcap;
    p.out = out + (size_t)b * outw;
    p.ncol = ncol;
    p.wcap = wcap;
    p.nscript = outw - 4;
    p.M = mnkl[4 * b];
    p.N = mnkl[4 * b + 1];
    p.K = mnkl[4 * b + 2];
    p.L = mnkl[4 * b + 3];
    std::barrier<> bar(32);
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([&, l] {
        EmuWarp w{l, &bar, slots};
        mzdp::yama_warp(p, ring.data(), w, go, ge);
      });
    for (auto& t : lanes) t.join();
  }
  return 0;
}
