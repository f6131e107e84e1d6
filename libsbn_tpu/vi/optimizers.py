"""VBPI optimizers: optax transforms + ELBO-feedback step-size control.

The reference ships a hand-rolled bank of first-order update rules
(vip/sgd_server.py) and two step-size controllers (vip/optimizers.py:83-127).
Per SURVEY.md §7 phase 5 that zoo collapses into optax gradient
transformations here; what stays domain-specific is

  * ascent (the objective is the ELBO) with independent step sizes for the
    two parameter groups (variational scalar params vs SBN params), and
  * step-size scheduling driven by ELBO feedback: decay-on-success /
    halve-on-nonfinite ("simple"), or grow-until-the-windowed-ELBO-drops,
    then restore the best parameters seen and decay ("bump").

Numeric behavior is pinned against the pre-rewrite implementation by
tests/test_vi.py::test_optimizer_trajectory_golden (scripted gradients →
identical parameters at 1e-12).
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import numpy as np
import optax

# Update rules, capability parity with the reference's SGD_Server zoo.
# Only "adam" (the one the reference training loop actually uses) is pinned
# by golden trajectories; the rest map onto the nearest optax transform.
RULES: Dict[str, Callable[[], optax.GradientTransformation]] = {
    "adam": lambda: optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
    "amsgrad": lambda: optax.scale_by_amsgrad(b1=0.9, b2=0.99, eps=1e-8),
    "rmsprop": lambda: optax.scale_by_rms(decay=0.9, eps=1e-8),
    "adagrad": lambda: optax.scale_by_rss(initial_accumulator_value=0.0),
    "adadelta": lambda: optax.scale_by_adadelta(rho=0.9, eps=1e-8),
    "sgd": lambda: optax.trace(decay=0.9),
}


class GroupedAscent:
    """One optax transform over a dict of parameter groups, with per-group
    step sizes applied outside the transform (they change every step under
    the controllers below, so they cannot be baked into a schedule)."""

    def __init__(self, example_params: Dict[str, np.ndarray], rule: str = "adam"):
        self._tx = RULES[rule]()
        # These are tiny updates of host-side parameters; run them on the
        # CPU so that each step costs no accelerator dispatch or transfer.
        try:
            self._cpu = jax.devices("cpu")[0]
        except RuntimeError:  # pragma: no cover - cpu platform disabled
            self._cpu = jax.devices()[0]
        with jax.default_device(self._cpu):
            self.state = self._tx.init(
                {k: np.asarray(v) for k, v in example_params.items()}
            )

    def ascent_updates(self, grads, params, step_sizes):
        """Transformed-gradient ascent deltas, scaled per group."""
        with jax.default_device(self._cpu):
            updates, self.state = self._tx.update(grads, self.state, params)
        return {k: step_sizes[k] * np.asarray(u) for k, u in updates.items()}

    # -- checkpoint support ------------------------------------------------
    def state_leaves(self):
        return [np.asarray(x) for x in jax.tree.leaves(self.state)]

    def load_state_leaves(self, leaves):
        treedef = jax.tree.structure(self.state)
        self.state = jax.tree.unflatten(treedef, list(leaves))


class BaseOptimizer:
    """Shared plumbing: holds the instance + scalar model whose parameters
    are updated in place, and delegates the post-step step-size policy to
    `update()` in subclasses."""

    def __init__(self, inst, scalar_model, elbo_estimator_fn: Callable):
        self.inst = inst
        self.scalar_model = scalar_model
        self.estimate_elbo = elbo_estimator_fn
        self.trace = []
        self.step_number = 0
        self.step_size = scalar_model.suggested_step_size()
        self.sbn_step_size = 0.001
        self.ascent = GroupedAscent(
            {
                "scalar_params": scalar_model.q_params,
                "sbn_params": np.asarray(inst.sbn_parameters),
            }
        )

    def _apply(self, grad_dict) -> bool:
        """One ascent step; False (and no state change) on non-finite scalar
        gradients so the controller can react."""
        assert self.scalar_model.q_params.shape == grad_dict["scalar_params"].shape
        if not np.isfinite(grad_dict["scalar_params"]).all():
            return False
        deltas = self.ascent.ascent_updates(
            grad_dict,
            {
                "scalar_params": self.scalar_model.q_params,
                "sbn_params": np.asarray(self.inst.sbn_parameters),
            },
            {"scalar_params": self.step_size, "sbn_params": self.sbn_step_size},
        )
        self.scalar_model.q_params += deltas["scalar_params"]
        self.inst.sbn_parameters = (
            np.asarray(self.inst.sbn_parameters) + deltas["sbn_params"]
        )
        return True

    def gradient_step(self, grad_dict):
        self.update(self._apply(grad_dict))

    def update(self, gradient_step_was_successful: bool):
        raise NotImplementedError


class SimpleOptimizer(BaseOptimizer):
    """Geometric step-size decay; halve on a failed (non-finite) step."""

    DECAY = 1 - 1e-2

    def update(self, ok: bool):
        if ok:
            self.step_size *= self.DECAY
        else:
            self.step_size /= 2
        self.step_number += 1


class BumpStepsizeOptimizer(BaseOptimizer):
    """Two-phase schedule: grow the step size by 1.2× per step while the
    ELBO (mean over a 5-step window, estimated at 500 particles) keeps
    improving; on the first windowed drop or non-finite gradient, restore
    the best q_params seen, cut the step size 4×, and decay from there."""

    WINDOW = 5
    GROW = 1.2
    DECAY = 1 - 1e-2
    DROP_FROM_PEAK = 4

    def __init__(self, inst, scalar_model, elbo_estimator_fn):
        super().__init__(inst, scalar_model, elbo_estimator_fn)
        self.stepsize_increasing = True
        self.best_elbo = -np.inf
        self.best_q_params = np.zeros(scalar_model.q_params.shape)

    def _window_dropped(self) -> bool:
        if self.step_number < 2 * self.WINDOW:
            return False
        last = np.mean(self.trace[-self.WINDOW:])
        prev = np.mean(self.trace[-2 * self.WINDOW: -self.WINDOW])
        return last < prev

    def _restore_best_and_drop(self):
        np.copyto(self.scalar_model.q_params, self.best_q_params)
        self.step_size /= self.DROP_FROM_PEAK
        self.stepsize_increasing = False

    def update(self, ok: bool):
        if not ok or (self.stepsize_increasing and self._window_dropped()):
            self._restore_best_and_drop()
        self.step_size *= self.GROW if self.stepsize_increasing else self.DECAY
        self.trace.append(self.estimate_elbo(particle_count=500))
        if self.trace[-1] > self.best_elbo:
            self.best_elbo = self.trace[-1]
            np.copyto(self.best_q_params, self.scalar_model.q_params)
        self.step_number += 1
        return np.isfinite(self.trace[-1])


def of_name(name: str, inst, scalar_model, elbo_estimator_fn) -> BaseOptimizer:
    choices = {"simple": SimpleOptimizer, "bump": BumpStepsizeOptimizer}
    if name not in choices:
        raise ValueError(f"Optimizer {name} not known.")
    return choices[name](inst, scalar_model, elbo_estimator_fn)
