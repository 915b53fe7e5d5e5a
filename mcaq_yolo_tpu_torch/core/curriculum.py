"""
Curriculum Learning Scheduler (paper Fig.3 / Sec IV-C / Algorithm 3): a
copy of `mcaq_yolo_tpu/core/curriculum.py`, which imports no framework; the
port keeps its own so that it imports nothing of the JAX package.

Pure functions of the epoch index, used host-side by the epoch loop:

  Stage 1 (0..Twarm):        warm-up — low-complexity samples, quantization
                             bypassed (high precision)
  Stage 2 (Twarm..Ttrans):   transition — mixed samples, dynamic bits,
                             temperature annealing
  Stage 3 (Ttrans..end):     full MCAQ
"""

from __future__ import annotations

import math
from typing import Dict


class CurriculumScheduler:
    def __init__(
        self,
        warmup_epochs: int = 20,        # Table X: Twarm = 20 (Stage 1 boundary)
        transition_epochs: int = 50,    # Fig.3: Stage 2 ends at epoch 50
        total_epochs: int = 300,        # Table X
        initial_complexity: float = 0.2,   # tau0
        initial_temperature: float = 10.0,  # alpha_0
        initial_bits: float = 8.0,
        target_bits: float = 4.0,
        curriculum_type: str = "exponential",  # 'linear'|'exponential'|'cosine'|'step'
        lambda_smooth: float = 0.1,     # Table X lambda2; scale down for finer grids
        lambda_bit_gate: bool = True,   # gate lambda1 during the alpha_t-saturation window
        min_bits: float = 2.0,          # bit-mapper output range (for the gate threshold)
        max_bits: float = 8.0,
        anneal_epochs: int | None = None,  # horizon for alpha_t + target-bits
        budget_anneal: str = "exp",     # 'exp' (reference) | 'exp_exact'
        budget_controller: bool = False,  # closed-loop budget enforcement
        controller_kp: float = 0.3,
        controller_deadband: float = 0.1,
        controller_max_boost: float = 8.0,
        controller_scale_kp: float = 0.7,
    ):
        self.warmup_epochs = warmup_epochs
        self.transition_epochs = transition_epochs
        self.total_epochs = total_epochs
        # -- anneal horizon (VERDICT r4 item 1: schedule compression) ------
        # The reference anneals alpha_t and target-bits over the FULL run
        # (total_epochs).  Combined with the saturation gate that is a
        # structural conflict at short protocols: the gate keys off
        # alpha_t, which crosses alpha_sat=1.6 only at t/T~0.54 and
        # reaches the 1.1 floor at t/T~0.9 — so lambda1 is fully on for
        # only the last ~10% of training, while the exp target-bits decay
        # plateaus at target + (init-target)e^-3 (~4.2 for 8->4).  r4's
        # measured 5.45-bit landing against a 4.0 target is mostly this.
        # anneal_epochs decouples the anneal horizon from the run length:
        # alpha_t and target-bits complete their schedules at
        # anneal_epochs (e.g. total//2), after which the model trains AT
        # deployment temperature with lambda1 at full gate strength for
        # the remaining half.  None (default) = total_epochs =
        # reference-exact.
        self.anneal_epochs = anneal_epochs or total_epochs
        # 'exp_exact' renormalizes the reference's exp decay so it hits
        # target_bits EXACTLY at the end of the anneal window instead of
        # plateauing e^-3 of the range above it:
        #   b(p) = target + (init-target) * (e^{-3p} - e^{-3}) / (1 - e^{-3})
        # 'exp' keeps the reference formula bit-for-bit.
        if budget_anneal not in ("exp", "exp_exact"):
            raise ValueError(f"budget_anneal must be 'exp' or 'exp_exact', "
                             f"got {budget_anneal!r}")
        self.budget_anneal = budget_anneal
        # -- closed-loop budget controller (VERDICT r4 item 1) -------------
        # Fixing the schedule alone leaves an EQUILIBRIUM residual: with
        # the reference's fixed lambda1 <= 0.1, dLbit/db = 2*lambda1*(b-t)
        # settles where it balances the detection loss's appetite for bits
        # (~0.5 loss-units/bit measured at the r3/r4 settling points) —
        # ~1-1.5 bits above target on hard data.
        #
        # TWO actuators, measured against each other in the round-5 pilots:
        #
        #   bit_scale      (PRIMARY) a host-side multiplicative trim on the
        #                  bit map, applied through the mapper's existing
        #                  temperature pathway (the reference already
        #                  multiplies bits by the alpha_t schedule scalar —
        #                  this is the same mechanism driven by the
        #                  measured budget instead of a clock):
        #                  s *= (target/measured)^scale_kp, clamped.
        #                  Instant and exact, and it PRESERVES the spatial
        #                  shape of the allocation (it scales, not crushes).
        #   lambda1 boost  (secondary, cap 8x) exp(kp * err) on lambda1 so
        #                  the mapper itself also learns toward the budget.
        #                  Measured WHY the boost alone fails (pilot r5-2):
        #                  Adam's per-parameter step is lr-bounded, so a
        #                  64x lambda1 moved the mean <0.2 bits in 10
        #                  epochs while the crush pressure flattened the
        #                  spatial std to 0.009 — budget still missed AND
        #                  the allocation destroyed.
        #
        # Both engage only once the allocation is live (gate == 1); boost
        # never drops below 1, scale recovers toward 1 on undershoot;
        # disabled (default) the reference semantics are untouched.
        self.budget_controller = budget_controller
        self.controller_kp = controller_kp
        self.controller_deadband = controller_deadband
        self.controller_max_boost = controller_max_boost
        self.controller_scale_kp = controller_scale_kp
        self.lambda1_boost = 1.0
        self.bit_scale = 1.0
        self.initial_complexity = initial_complexity
        self.initial_temperature = initial_temperature
        self.initial_bits = initial_bits
        self.target_bits = target_bits
        self.curriculum_type = curriculum_type
        self.lambda_smooth = lambda_smooth
        self.lambda_bit_gate = lambda_bit_gate
        self.min_bits = min_bits
        self.max_bits = max_bits
        self.current_epoch = 0

    # -- stage ---------------------------------------------------------
    def get_stage(self, epoch: int) -> int:
        """{1, 2, 3} per the three-stage schedule (boundaries inclusive on
        the left stage, matching the reference curriculum.py:66-83)."""
        if epoch <= self.warmup_epochs:
            return 1
        if epoch <= self.transition_epochs:
            return 2
        return 3

    # -- complexity threshold tau_t (Algorithm 3 line 5) ----------------
    def get_complexity_threshold(self, epoch: int) -> float:
        """tau_t = tau0 + (1 - tau0) * t/Twarm for t <= Twarm, then 1.0."""
        if epoch <= self.warmup_epochs:
            if self.warmup_epochs == 0:  # no warm-up: threshold fully open
                return 1.0
            progress = epoch / self.warmup_epochs
            return self.initial_complexity + (1.0 - self.initial_complexity) * progress
        return 1.0

    # -- temperature alpha_t (Algorithm 3 line 10) ----------------------
    def get_temperature(self, epoch: int) -> float:
        T = self.anneal_epochs
        if self.curriculum_type == "linear":
            p = min(epoch / T, 1.0)
            return self.initial_temperature * (1.0 - p) + 1.0 * p
        if self.curriculum_type == "exponential":
            # alpha_t = 1 + (alpha_0 - 1) * exp(-5 t / T)  (paper: 1 + 9 e^{-5t/T})
            t = min(epoch, T)
            return 1.0 + (self.initial_temperature - 1.0) * math.exp(-5.0 * t / max(1, T))
        if self.curriculum_type == "cosine":
            p = min(epoch / T, 1.0)
            return 1.0 + 0.5 * (self.initial_temperature - 1.0) * (1 + math.cos(math.pi * p))
        if self.curriculum_type == "step":
            temp = self.initial_temperature
            for milestone in (30, 60, 90, 120):
                if epoch >= milestone:
                    temp *= 0.5
            return temp
        return 1.0

    def get_effective_temperature(self, epoch: int) -> float:
        """alpha_t x the controller's bit_scale trim (1.0 when the
        controller is off/idle).  The trim persists at deployment: a model
        trained under bit_scale=s deploys its bit maps at temperature s
        (saved as 'deploy_temperature' in checkpoint meta)."""
        return self.get_temperature(epoch) * self.bit_scale

    # -- target bits -----------------------------------------------------
    def get_target_bits(self, epoch: int) -> float:
        """8 during warm-up, then exponential (default) or linear decay to
        the target (reference curriculum.py:152-177)."""
        if epoch < self.warmup_epochs:
            return self.initial_bits
        progress = (epoch - self.warmup_epochs) / max(
            1, self.anneal_epochs - self.warmup_epochs)
        progress = min(progress, 1.0)
        if self.curriculum_type == "exponential":
            if self.budget_anneal == "exp_exact":
                # same exp shape, renormalized to land ON target at p=1
                k = math.exp(-3.0)
                frac = (math.exp(-3.0 * progress) - k) / (1.0 - k)
                return self.target_bits + (
                    self.initial_bits - self.target_bits) * frac
            return self.target_bits + (self.initial_bits - self.target_bits) * math.exp(
                -3.0 * progress
            )
        return self.initial_bits - (self.initial_bits - self.target_bits) * progress

    # -- bookkeeping -----------------------------------------------------
    def step(self):
        self.current_epoch += 1

    def get_current_params(self) -> Dict:
        e = self.current_epoch
        return {
            "epoch": e,
            "complexity_threshold": self.get_complexity_threshold(e),
            "temperature": self.get_temperature(e),
            "target_bits": self.get_target_bits(e),
        }

    def should_update_bit_allocation(self, epoch: int) -> bool:
        update_interval = 10
        return epoch > self.warmup_epochs and epoch % update_interval == 0

    # -- lambda1/lambda2 saturation gate ------------------------------------
    def get_bit_budget_gate(self, epoch: int) -> float:
        """Gate factor in [0, 1] on the AUXILIARY bit-map pressures
        (lambda1 bit-budget AND lambda2 smoothness) during the
        alpha_t-saturation window — the fix for the MLP-mapper collapse
        (PARITY.md "MLP-mapper degeneracy"; VERDICT r3 item 2).

        While alpha_t still clamps the whole map at max_bits, avg_bits is
        max_bits REGARDLESS of the mapper's parameters, so Lbit's STE
        gradient is pure one-sided crush pressure that the detection loss
        cannot counter (everything is still 8-bit, quantization is
        harmless) — that window is what drives the Eq.13-18 mapper into
        its two absorbing states (projection zero-trap / dead-ReLU trap).
        Lsmooth has the SAME structure one module upstream: through the
        transition band (map partially unsaturated but bits still high)
        its TV gradient flattens the bit map — and, through the mapper,
        the complexity MLP itself — while quantization is still harmless,
        so detection offers no counterweight (measured: a 640px run with
        only lambda1 gated deployed a complexity map with spatial std
        0.0 — the collapse simply moved upstream).  Both weights
        therefore ramp in together once the allocation is live.
        The map first LEAVES saturation when alpha_t * b(C) < max_bits for
        mid-range tiles, i.e. below alpha_sat = max_bits / b_mid with
        b_mid = (min_bits + max_bits) / 2 (1.6 for the default [2, 8]
        range).  The gate ramps lambda1 in linearly over
        alpha_t in [alpha_sat, 1.1]: zero while the map is pinned, full
        strength once the allocation is live (alpha_t <= 1.1, ~90% through
        the exponential anneal — alpha_t only reaches 1 asymptotically)
        and detection loss provides the counter-pressure.
        Schedule-structural and data-free — pure reference semantics
        otherwise (the Eq.18 |W| projection and the 'abs'
        parameterization are untouched)."""
        if not self.lambda_bit_gate:
            return 1.0
        b_mid = 0.5 * (self.min_bits + self.max_bits)
        alpha_sat = self.max_bits / max(b_mid, 1e-6)
        alpha_floor = 1.1
        if alpha_sat <= alpha_floor:
            return 1.0
        alpha = self.get_temperature(epoch)
        return min(1.0, max(0.0,
                            (alpha_sat - alpha) / (alpha_sat - alpha_floor)))

    # -- closed-loop budget controller update ------------------------------
    def update_budget_controller(self, measured_bits: float,
                                 epoch: int) -> float:
        """Feed back the epoch's measured mean bit width.  Call once per
        epoch AFTER training it; updates bit_scale (primary actuator, see
        __init__ comment) and the lambda1 boost for the NEXT epoch.
        Returns the new bit_scale.  No-op unless budget_controller is on
        and the allocation is live (saturation gate fully open —
        controlling while alpha_t still pins the map would just re-create
        the crush-pressure pathology the gate exists to prevent)."""
        if not self.budget_controller:
            return self.bit_scale
        if self.get_bit_budget_gate(epoch) < 1.0:
            return self.bit_scale
        target = self.get_target_bits(epoch)
        err = float(measured_bits) - target
        if abs(err) <= self.controller_deadband:
            return self.bit_scale
        self.bit_scale = float(min(1.3, max(0.5,
            self.bit_scale * (target / max(float(measured_bits), 1e-6))
            ** self.controller_scale_kp)))
        self.lambda1_boost = float(min(
            self.controller_max_boost,
            max(1.0, self.lambda1_boost * math.exp(self.controller_kp * err)),
        ))
        return self.bit_scale

    # -- loss weights (paper Eq.20 + Table X) ------------------------------
    def get_loss_weights(self, epoch: int) -> Dict[str, float]:
        """lambda1 annealed 0.01 -> 0.1 and lambda2 ramped 0 ->
        lambda_smooth across the transition stage (nothing to smooth
        during the high-precision warm-up), BOTH gated by the
        alpha_t-saturation window (see get_bit_budget_gate; disable with
        lambda_bit_gate=False for the reference-exact schedule);
        lambda3 = 0.5; lambda4 = 1e-4."""
        progress = min(epoch / max(1, self.total_epochs), 1.0)
        lambda1 = 0.01 + (0.1 - 0.01) * progress
        gate = self.get_bit_budget_gate(epoch)

        span = max(1, self.transition_epochs - self.warmup_epochs)
        ramp = min(1.0, max(0.0, (epoch - self.warmup_epochs) / span))

        return {
            "detection": 1.0,
            "bit_budget": lambda1 * gate * self.lambda1_boost,
            "smoothness": self.lambda_smooth * ramp * gate,
            "distillation": 0.5,
            "regularization": 1e-4,
        }
