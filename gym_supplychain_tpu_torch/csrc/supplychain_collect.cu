// The collect kernel's chain descriptor at its size limits, and the error
// strings of every launch entry.
//
// `ScChain` is `ChainT` (supplychain_step.cuh) at the limits `_MAX` of
// ops/supplychain_collect.py, whose `chain_descriptor` lays a chain out as
// its bytes and refuses a chain beyond them.  The kernels on the small
// chains (K1 in every mode, K4, K6a) run the lane-group step on `DnChain`
// instead (supplychain_lanes.cuh, supplychain_policy.cu) and keep those
// limits; tests/test_torch_collect.py holds the Python layout against this
// struct.
#include <cuda_runtime.h>

#include "supplychain_step.cuh"

#define SC_MAX_N 32
#define SC_MAX_P 8
#define SC_MAX_NP 32
#define SC_MAX_D 8
#define SC_MAX_ND 256
#define SC_MAX_NPD 256
#define SC_MAX_RING 8
#define SC_MAX_RP 16
#define SC_MAX_CDF 8

using ScChain = ChainT<SC_MAX_N, SC_MAX_P, SC_MAX_NP, SC_MAX_D, SC_MAX_ND,
                       SC_MAX_NPD, SC_MAX_RING, SC_MAX_RP, SC_MAX_CDF>;

extern "C" const char* gst_error_string(int code) {
  if (code == -1) return "chain descriptor size differs from the kernel's";
  if (code == -2) return "beer game levels or ring exceed the kernel limits";
  if (code == -3) return "unknown collect mode";
  if (code == -4) return "MLP layout differs from the kernel's";
  if (code == -5) return "shared memory too small for the block's envs";
  if (code == -6) return "no lane-kernel instance for these lanes, envs and slots";
  if (code == -7) return "no bf16 update-kernel instance for these widths";
  if (code == -8) return "episode-table shapes out of range or descriptor too short";
  return cudaGetErrorString((cudaError_t)code);
}
