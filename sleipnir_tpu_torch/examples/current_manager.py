"""Current manager example on sleipnir_tpu_torch (reference
examples/current_manager/current_manager.py).

Computes the optimal current allocation for a list of subsystems given
desired currents and per-subsystem tolerances; smaller tolerance = higher
priority when the current budget is exceeded.
"""

from __future__ import annotations

import argparse

from sleipnir_tpu_torch import Problem, Variable, VariableMatrix


class CurrentManager:
    """Optimal current allocator (a parametric QP re-solved per cycle)."""

    def __init__(
        self, current_tolerances: list[float], max_current: float, device: str = "cuda"
    ):
        self._device = device
        self._desired_currents = []
        self._problem = Problem()
        self._allocated_currents = self._problem.decision_variable(
            len(current_tolerances)
        )

        # Desired currents are runtime parameters: the problem compiles
        # once, and set_value feeds new values without recompiling (the
        # reference needs a Variable(inf) trick here to suppress constant
        # folding; parameters make that automatic).
        for _ in range(len(current_tolerances)):
            self._desired_currents.append(Variable(float("inf")))

        J = 0.0
        current_sum = 0.0
        for i, tolerance in enumerate(current_tolerances):
            error = self._desired_currents[i] - self._allocated_currents[i]
            J += error * error / (tolerance * tolerance)
            current_sum += self._allocated_currents[i]
            self._problem.subject_to(self._allocated_currents[i] >= 0.0)
        self._problem.minimize(J)
        self._problem.subject_to(current_sum <= max_current)

    def calculate(self, desired_currents: list[float]) -> list[float]:
        if len(self._desired_currents) != len(desired_currents):
            raise ValueError(
                "Number of desired currents must equal the number of "
                "tolerances passed in the constructor."
            )
        for i, current in enumerate(desired_currents):
            self._desired_currents[i].set_value(current)

        self._problem.solve(device=self._device)

        return [
            max(self._allocated_currents.value(i), 0.0)
            for i in range(len(desired_currents))
        ]


def main(device: str = "cuda") -> None:
    manager = CurrentManager([1.0, 5.0, 10.0, 5.0], 40.0, device=device)
    currents = manager.calculate([25.0, 10.0, 5.0, 0.0])
    print("Enough current:", currents)
    currents = manager.calculate([30.0, 10.0, 5.0, 0.0])
    print("Overbudget:", currents)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
