"""Learning-rate schedule: StepLR with a min-lr step gate.

Counterpart of ``seld_tpu/training/schedule.py`` (the reference's scheduler
usage): ``StepLR(step_size, gamma)`` is stepped once per epoch, but only
while the current lr is still above ``min_lr`` — once it decays to
``min_lr`` the epoch counter freezes, so the floor is sticky. The lr after E
performed steps is ``lr0 * gamma ** (E // step_size)``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class StepLRState:
    lr0: float
    step_size: int
    gamma: float
    min_lr: float
    enabled: bool = True
    steps_taken: int = 0

    @property
    def lr(self) -> float:
        return self.lr0 * self.gamma ** (self.steps_taken // self.step_size)

    def epoch_step(self) -> "StepLRState":
        """Advance one epoch (call after validation, like the reference)."""
        if self.enabled and self.lr > self.min_lr:
            return replace(self, steps_taken=self.steps_taken + 1)
        return self


def schedule_from_config(cfg) -> StepLRState:
    return StepLRState(
        lr0=cfg.lr,
        step_size=cfg.lr_scheduler_step_size,
        gamma=cfg.lr_scheduler_gamma,
        min_lr=cfg.min_lr,
        enabled=cfg.use_lr_scheduler,
    )
