"""Internal device-side status codes for the jitted solver loops.

ExitStatus values (reference solver/exit_status.hpp) plus two sentinels that
only exist while a solve is in flight.
"""

#: Solve still in progress (device loop keeps iterating).
RUNNING = 100
#: The line search failed and the solver wants the host to run feasibility
#: restoration (a different-shaped subproblem; see SURVEY.md §7).
FEASIBILITY_RESTORATION_REQUESTED = 101
