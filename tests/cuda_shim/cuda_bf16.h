// Empty: tests/cuda_shim/shim.h, included first, stands in for it.
#pragma once
