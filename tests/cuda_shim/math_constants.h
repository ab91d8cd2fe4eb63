#pragma once
#include <cmath>
#define CUDART_INF_F INFINITY
