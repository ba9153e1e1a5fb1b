// CPU stand-in for the CUDA header of the same name: the cp.async
// primitives are plain copies, defined in cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
