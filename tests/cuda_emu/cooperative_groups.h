// CPU stand-in for the grid group of cooperative_groups.h: grid.sync() is
// the cooperative launch's barrier over every thread of the grid (see
// cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() const { emu_grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
