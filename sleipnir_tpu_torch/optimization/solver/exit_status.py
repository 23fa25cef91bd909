"""Solver exit status taxonomy (reference solver/exit_status.hpp:14-45)."""

import enum


class ExitStatus(enum.IntEnum):
    """Solver exit status. Negative values indicate failure."""

    #: Solved the problem to the desired tolerance.
    SUCCESS = 0
    #: The solver returned its solution so far after the user requested a stop.
    CALLBACK_REQUESTED_STOP = 1
    #: The solver determined the problem to be overconstrained and gave up.
    TOO_FEW_DOFS = -1
    #: The solver determined the problem to be locally infeasible and gave up.
    LOCALLY_INFEASIBLE = -2
    #: The problem setup frontend determined the problem to have an empty
    #: feasible region.
    GLOBALLY_INFEASIBLE = -3
    #: The linear system factorization failed.
    FACTORIZATION_FAILED = -4
    #: The backtracking line search failed, and the problem isn't locally
    #: infeasible.
    LINE_SEARCH_FAILED = -5
    #: The solver failed to reach the desired tolerance, and feasibility
    #: restoration failed to converge.
    FEASIBILITY_RESTORATION_FAILED = -6
    #: The solver encountered nonfinite initial cost, constraints, or
    #: derivatives and gave up.
    NONFINITE_INITIAL_GUESS = -7
    #: The solver encountered diverging primal iterates xₖ and/or sₖ and gave
    #: up.
    DIVERGING_ITERATES = -8
    #: The solver returned its solution so far after exceeding the maximum
    #: number of iterations.
    MAX_ITERATIONS_EXCEEDED = -9
    #: The solver returned its solution so far after exceeding the maximum
    #: elapsed wall clock time.
    TIMEOUT = -10

    def __str__(self) -> str:
        return {
            ExitStatus.SUCCESS: "success",
            ExitStatus.CALLBACK_REQUESTED_STOP: "callback requested stop",
            ExitStatus.TOO_FEW_DOFS: "too few degrees of freedom",
            ExitStatus.LOCALLY_INFEASIBLE: "locally infeasible",
            ExitStatus.GLOBALLY_INFEASIBLE: "globally infeasible",
            ExitStatus.FACTORIZATION_FAILED: "factorization failed",
            ExitStatus.LINE_SEARCH_FAILED: "line search failed",
            ExitStatus.FEASIBILITY_RESTORATION_FAILED: (
                "feasibility restoration failed"
            ),
            ExitStatus.NONFINITE_INITIAL_GUESS: "nonfinite initial guess",
            ExitStatus.DIVERGING_ITERATES: "diverging iterates",
            ExitStatus.MAX_ITERATIONS_EXCEEDED: "max iterations exceeded",
            ExitStatus.TIMEOUT: "timeout",
        }[self]
