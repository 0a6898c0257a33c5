// The launch geometry of a kernel's entry point, shared by its
// `<name>_launch` (which launches with it) and its `<name>_geometry` (which
// reports it), so that the two cannot drift.
//
// `<name>_geometry(<the launch's int arguments>, int* out)` fills out[16]:
//   out[0..2]   the first launch's grid (x, y, z),
//   out[3..5]   its block (x, y, z),
//   out[6]      its dynamic shared memory, bytes,
//   out[7]      the split (split-K partials, or split-KV blocks; 1 unsplit),
//   out[8]      the pipeline stages of its shared-memory ring (0: none),
//   out[9..11]  the second launch's grid (a split's reduce or combine; 0s
//               where there is none),
//   out[12..14] its block,
//   out[15]     0.
// A call that launches nothing reports a zero grid. The entry point returns
// 0, or what a failed device query returned.
#pragma once

#include <cuda_runtime.h>

namespace geometry {

struct Launch {
  dim3 grid{0, 0, 0};
  dim3 block{0, 0, 0};
  int smem = 0;
};

struct Geometry {
  Launch first, second;
  int split = 1;
  int stages = 0;
};

inline void put(const Geometry& g, int* out) {
  const Launch* ls[2] = {&g.first, &g.second};
  for (int i = 0; i < 2; ++i) {
    int* o = out + (i == 0 ? 0 : 9);
    o[0] = (int)ls[i]->grid.x;
    o[1] = (int)ls[i]->grid.y;
    o[2] = (int)ls[i]->grid.z;
    o[3] = (int)ls[i]->block.x;
    o[4] = (int)ls[i]->block.y;
    o[5] = (int)ls[i]->block.z;
  }
  out[6] = g.first.smem;
  out[7] = g.split;
  out[8] = g.stages;
  out[15] = 0;
}

// The card's SM count, read once.
inline int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = cached;
  return 0;
}

}  // namespace geometry
