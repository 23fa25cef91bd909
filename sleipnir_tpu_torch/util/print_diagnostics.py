"""Diagnostic table printers (reference util/print_diagnostics.hpp:93-318).

Port of `sleipnir_tpu/util/print_diagnostics.py`, character for
character. Reproduces the reference's unicode iteration table and
solver/setup time traces so the `diagnostics=True` output reads
identically.
"""

from __future__ import annotations

import math
from typing import Sequence

NORMAL = 0
SECOND_ORDER_CORRECTION = 1
FEASIBILITY_RESTORATION = 2

_ITERATION_TYPES = [" ", "s", "r"]


def _power_of_10(value: float) -> str:
    """Format a regularization factor as a power of ten (reference
    print_diagnostics.hpp power_of_10)."""
    if value == 0.0:
        return "0"
    exponent = int(math.floor(math.log10(abs(value))))
    return f"1e{exponent:+d}" if value > 0 else f"-1e{exponent:+d}"


def print_iteration_diagnostics(
    iterations: int,
    iteration_type: int,
    time_ms: float,
    error: float,
    cost: float,
    infeasibility: float,
    complementarity: float,
    mu: float,
    delta: float,
    gamma: float,
    full_primal_step_inf_norm: float,
    full_dual_step_inf_norm: float,
    primal_alpha: float,
    primal_alpha_max: float,
    alpha_reduction_factor: float,
    dual_alpha: float,
) -> None:
    """One row of the iteration table (reference
    print_diagnostics.hpp:194-240)."""
    if iterations % 20 == 0:
        top = "┏" if iterations == 0 else "┢"
        topr = "┓" if iterations == 0 else "┪"
        print(f"{top}{'━' * 119}{topr}")
        header = (
            f"┃{'iter':^4}   {'duration':^9} {'error':^10} {'cost':^11} "
            f"{'infeas.':^10} {'complem.':^8} {'μ':^8} {'δ':^5} {'γ':^5} "
            f"{'|p_pr|':^8} {'|p_du|':^8} {'α_pr':^8} {'α_du':^8} {'↩':^2}┃"
        )
        print(header)
        print(f"┡{'━' * 119}┩")

    if primal_alpha > 0 and primal_alpha_max > 0 and alpha_reduction_factor:
        backtracks = int(
            math.log(primal_alpha / primal_alpha_max)
            / math.log(alpha_reduction_factor)
        )
    else:
        backtracks = 0

    print(
        f"│{iterations:4} {_ITERATION_TYPES[iteration_type]:1} "
        f"{time_ms:9.3f} {error:10.4e} {cost:11.4e} {infeasibility:10.4e} "
        f"{complementarity:8.2e} {mu:8.2e} {_power_of_10(delta):<5} "
        f"{_power_of_10(gamma):<5} {full_primal_step_inf_norm:8.2e} "
        f"{full_dual_step_inf_norm:8.2e} {primal_alpha:8.2e} "
        f"{dual_alpha:8.2e} {backtracks:2d}│"
    )


def print_bottom_iteration_diagnostics() -> None:
    print(f"└{'─' * 119}┘")


def histogram(value: float, width: int = 9) -> str:
    """Unicode bar (reference print_diagnostics.hpp histogram<Width>)."""
    value = min(max(value, 0.0), 1.0)
    strs = [" ", "▏", "▎", "▍", "▌", "▋", "▊", "▉", "█"]
    ipart = int(value * width)
    fpart = int((value * width - ipart) * 8)
    out = strs[8] * ipart
    if fpart > 0:
        out += strs[fpart]
    return out.ljust(width)


def print_solver_diagnostics(solve_profilers: Sequence) -> None:
    """Time-trace table (reference print_diagnostics.hpp:289-311)."""
    total_ms = solve_profilers[0].total * 1e3
    print(f"┏{'━' * 66}┓")
    print(
        f"┃{'time trace':^21} {'percentage':^18} {'total':^10} "
        f"{'each':^9} {'runs':^4}┃"
    )
    print(f"┡{'━' * 66}┩")
    for profiler in solve_profilers:
        if total_ms == 0.0:
            norm = 1.0 if profiler is solve_profilers[0] else 0.0
        else:
            norm = profiler.total * 1e3 / total_ms
        print(
            f"│{profiler.name:<21} {norm * 100.0:>6.2f}%▕{histogram(norm)}▏ "
            f"{profiler.total * 1e3:>10.3f} {profiler.average * 1e3:>9.3f} "
            f"{profiler.count:>4}│"
        )
    print(f"└{'─' * 66}┘")


def print_setup_diagnostics(setup_profilers: Sequence) -> None:
    """Setup time-trace table (reference print_diagnostics.hpp:313-330)."""
    total_ms = setup_profilers[0].duration * 1e3
    print(f"┏{'━' * 50}┓")
    print(f"┃{'time trace':^21} {'percentage':^18} {'duration':^9}┃")
    print(f"┡{'━' * 50}┩")
    for profiler in setup_profilers:
        if total_ms == 0.0:
            norm = 1.0 if profiler is setup_profilers[0] else 0.0
        else:
            norm = profiler.duration * 1e3 / total_ms
        print(
            f"│{profiler.name:<21} {norm * 100.0:>6.2f}%▕{histogram(norm)}▏ "
            f"{profiler.duration * 1e3:>9.3f}│"
        )
    print(f"└{'─' * 50}┘")


def print_exit_conditions(options) -> None:
    """(reference print_diagnostics.hpp print_exit_conditions)"""
    print("User-configured exit conditions:")
    print(f"  ↳ error below {options.tolerance}")
    if options.max_iterations != 5000 or True:
        print(f"  ↳ executed {options.max_iterations} iterations")
    if math.isfinite(options.timeout):
        print(f"  ↳ {options.timeout} seconds elapsed")


def print_problem_analysis(
    num_decision_variables: int,
    cost_type,
    num_equality: int,
    equality_type,
    num_inequality: int,
    inequality_type,
) -> None:
    """Problem structure report (reference problem.hpp:768-816)."""
    print("Problem structure:")
    print(f"  ↳ {num_decision_variables} decision variables")
    print(f"  ↳ {cost_type} cost function")
    print(f"  ↳ {num_equality} {equality_type} equality constraints")
    print(f"  ↳ {num_inequality} {inequality_type} inequality constraints")
