"""L-BFGS with a zoom line search: ``optax.lbfgs()`` at its defaults, in
torch, for one parameter tensor.

``torch.optim.LBFGS`` searches its line otherwise (strong Wolfe by cubic
interpolation only, another initial step and update order), so it does not
take the JAX package's steps.  This is optax 0.2's algorithm:

  * ``scale_by_lbfgs`` (memory 10, ``scale_init_precond``): the memory
    takes the differences of the parameters and gradients since the last
    call, then the two-loop recursion preconditions the gradient, the
    identity scaled by ``<du, dw> / |du|^2``, or ``min(1, 1/|g|)`` at the
    first call;
  * the direction is minus that, and ``scale_by_zoom_linesearch`` (at most
    20 evaluations, initial guess 1, sufficient decrease 1e-4 with the
    approximate-decrease test at 1e-6, curvature 0.9, interval threshold
    1e-5) picks the step: interval search by doubling, then zoom by cubic,
    quadratic or bisection steps; if it fails, the safe step that met the
    decrease test;
  * ``value_and_grad_from_state``: each step after the first starts from
    the value and gradient the line search took at its accepted step.

The vector arithmetic runs in the tensor's type on its device; the line
search's scalars are host float64 (JAX keeps them in the parameters' type).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0


def _vdot(a, b) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _nan_max(a, b):
    return np.float64("nan") if np.isnan(a) or np.isnan(b) else max(a, b)


def _nan_min(a, b):
    return np.float64("nan") if np.isnan(a) or np.isnan(b) else min(a, b)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * abs(value_init)
    err = _nan_min(_nan_max(approx, delta_values), err)
    err = _nan_max(err, np.float64(0.0))
    return np.float64("inf") if np.isnan(err) else err


def _curvature_error(slope_step, slope_init):
    err = _nan_max(abs(slope_step) - CURV_RTOL * abs(slope_init), np.float64(0.0))
    return np.float64("inf") if np.isnan(err) else err


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0, r1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r0 + -(db ** 2) * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _Search:
    """One round of the zoom line search along ``updates`` from ``params``."""

    def __init__(self, params, updates, value, grad, value_and_grad):
        self.params, self.updates, self.value_and_grad = params, updates, value_and_grad
        slope = np.float64(_vdot(updates, grad).item())
        f64 = np.float64
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = f64(0.0), value, grad, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = f64("inf")
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = f64(0.0), value, slope
        self.high, self.value_high, self.slope_high = f64(0.0), value, slope
        self.cubic_ref, self.value_cubic_ref = f64(0.0), value
        self.safe_stepsize, self.safe_value, self.safe_grad = f64(0.0), value, grad

    def _on_line(self, stepsize):
        value, grad = self.value_and_grad(self.params + float(stepsize) * self.updates)
        return np.float64(value.item()), grad, np.float64(_vdot(grad, self.updates).item())

    def _errors(self, stepsize, value, slope):
        dec = _decrease_error(stepsize, value, slope, self.value_init, self.slope_init)
        curv = _curvature_error(slope, self.slope_init)
        return dec, curv, max(dec, curv)

    def _search_interval(self):
        new = (np.float64(1.0) if self.count == 0
               else np.float64(INCREASE_FACTOR) * self.stepsize)
        value, grad, slope = self._on_line(new)
        dec, curv, error = self._errors(new, value, slope)
        if dec <= TOL:
            self.safe_stepsize, self.safe_value, self.safe_grad = new, value, grad
        set_high = dec > 0.0 or (value >= self.value and self.count > 0)
        set_low = slope >= 0.0 and not set_high
        prev = (self.stepsize, self.value, self.slope)
        if set_low:
            (self.low, self.value_low, self.slope_low), (
                self.high, self.value_high, self.slope_high) = (new, value, slope), prev
        else:
            (self.low, self.value_low, self.slope_low), (
                self.high, self.value_high, self.slope_high) = prev, (new, value, slope)
        self.interval_found = set_high or set_low or error <= TOL
        self.done = error <= TOL
        self.failed = self.count + 1 >= MAX_LINESEARCH_STEPS and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self._take(new, value, grad, slope, dec, curv)

    def _zoom(self):
        low, high = self.low, self.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        with np.errstate(all="ignore"):
            cubic = _cubicmin(low, self.value_low, self.slope_low, high, self.value_high,
                              self.cubic_ref, self.value_cubic_ref)
            quad = _quadmin(low, self.value_low, self.slope_low, high, self.value_high)
        if left + 0.2 * delta < cubic < right - 0.2 * delta:
            middle = cubic
        elif left + 0.1 * delta < quad < right - 0.1 * delta:
            middle = quad
        else:
            middle = (low + high) / 2.0
        value, grad, slope = self._on_line(middle)
        dec, curv, error = self._errors(middle, value, slope)
        if dec <= TOL and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = middle, value, grad
        self.done = error <= TOL
        set_high_to_middle = dec > 0.0 or value >= self.value_low
        set_high_to_low = slope * (high - low) >= 0.0 and not set_high_to_middle
        old_low = (low, self.value_low, self.slope_low)
        if set_high_to_middle or set_high_to_low:
            self.cubic_ref, self.value_cubic_ref = high, self.value_high
        else:
            self.cubic_ref, self.value_cubic_ref = low, self.value_low
        if set_high_to_middle:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if set_high_to_low:
            self.high, self.value_high, self.slope_high = old_low
        if not set_high_to_middle:
            self.low, self.value_low, self.slope_low = middle, value, slope
        failed = (self.count + 1 >= MAX_LINESEARCH_STEPS
                  or (delta <= INTERVAL_THRESHOLD and self.safe_stepsize > 0.0))
        self.failed = failed and not self.done
        self._take(middle, value, grad, slope, dec, curv)

    def _take(self, stepsize, value, grad, slope, dec, curv):
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = stepsize, value, grad, slope
        self.decrease_error, self.curvature_error = dec, curv

    def run(self):
        """Search until done or failed; returns (stepsize, value, grad)."""
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom()
            else:
                self._search_interval()
            if self.failed and (self.safe_stepsize > 0.0
                                or math.isinf(self.decrease_error)):
                self.stepsize, self.value, self.grad = (
                    self.safe_stepsize, self.safe_value, self.safe_grad)
        return self.stepsize, self.value, self.grad


class LBFGS:
    """``optax.lbfgs()`` on one tensor.  ``step(params, value_and_grad)``
    returns ``(params + stepsize · direction, value)``: the new parameters
    before any projection the caller applies, and the objective's value at
    ``params``, the one the step started from (as ``value_and_grad_from_
    state`` gives it to optax's update)."""

    def __init__(self, memory_size: int = MEMORY_SIZE):
        self.m = memory_size
        self.count = 0
        self.params = self.grad = None  # at the last step's start
        self.dw: list = [None] * memory_size
        self.du: list = [None] * memory_size
        self.rho: list = [None] * memory_size
        self.value = None  # the line search's accepted value and gradient
        self.value_grad = None

    def _precondition(self, params, grad):
        """The memory's update, then P_k g by the two-loop recursion
        (``scale_by_lbfgs``)."""
        zero = grad.new_zeros(())
        if self.count > 0:
            dw, du = params - self.params, grad - self.grad
            vdot = _vdot(du, dw)
            self.dw[(self.count - 1) % self.m] = dw
            self.du[(self.count - 1) % self.m] = du
            self.rho[(self.count - 1) % self.m] = torch.where(vdot == 0.0, zero, 1.0 / vdot)
            den = _vdot(du, du)
            scale = torch.where(den > 0.0, vdot / den, zero + 1.0)
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        indices = [(self.count % self.m + i) % self.m for i in range(self.m)]
        vec, alphas = grad, {}
        for idx in reversed(indices):
            if self.rho[idx] is None:
                alphas[idx] = None
                continue
            alphas[idx] = self.rho[idx] * _vdot(self.dw[idx], vec)
            vec = vec + (-alphas[idx]) * self.du[idx]
        vec = scale * vec
        for idx in indices:
            if alphas[idx] is None:
                continue
            beta = self.rho[idx] * _vdot(self.du[idx], vec)
            vec = vec + (alphas[idx] - beta) * self.dw[idx]
        self.params, self.grad = params, grad
        self.count += 1
        return vec

    def step(self, params: torch.Tensor,
             value_and_grad: Callable[[torch.Tensor], tuple]) -> tuple:
        if self.value is None or not math.isfinite(self.value):
            value, grad = value_and_grad(params)
            value = np.float64(value.item())
        else:
            value, grad = self.value, self.value_grad
        direction = -self._precondition(params, grad)
        stepsize, self.value, self.value_grad = _Search(
            params, direction, value, grad, value_and_grad).run()
        return params + float(stepsize) * direction, value


def minimize(value_and_grad: Callable, params: torch.Tensor, num_steps: int,
             project: Optional[Callable] = None) -> tuple:
    """``num_steps`` L-BFGS steps from ``params``, ``project`` (e.g. a
    clamp) applied after each; returns (params, the value each step started
    from)."""
    opt = LBFGS()
    values = []
    for _ in range(num_steps):
        params, value = opt.step(params, value_and_grad)
        if project is not None:
            params = project(params)
        values.append(value)
    return params, values
