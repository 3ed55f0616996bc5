"""Solver status codes.

Mirrors the reference's Ipopt-style integer status dictionary
(SqpSolver.jl ``src/status.jl:2-23``) so that a user of the reference finds
the same codes and meanings here.  Statuses are plain ints inside the solver
(carried in the batched solver state) and mapped to names at the API boundary.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Return status of the SQP solver (reference: src/status.jl)."""

    SOLVE_SUCCEEDED = 0
    SOLVED_TO_ACCEPTABLE_LEVEL = 1
    INFEASIBLE_PROBLEM_DETECTED = 2
    SEARCH_DIRECTION_BECOMES_TOO_SMALL = 3
    DIVERGING_ITERATES = 4
    USER_REQUESTED_STOP = 5
    FEASIBLE_POINT_FOUND = 6
    MAXIMUM_ITERATIONS_EXCEEDED = -1
    RESTORATION_FAILED = -2
    ERROR_IN_STEP_COMPUTATION = -3
    MAXIMUM_CPUTIME_EXCEEDED = -4
    OPTIMIZE_NOT_CALLED = -5
    METHOD_NOT_DEFINED = -6
    NOT_ENOUGH_DEGREES_OF_FREEDOM = -10
    INVALID_PROBLEM_DEFINITION = -11
    INVALID_OPTION = -12
    INVALID_NUMBER_DETECTED = -13
    UNRECOVERABLE_EXCEPTION = -100
    INSUFFICIENT_MEMORY = -102
    INTERNAL_ERROR = -199


#: Human-readable names, matching reference ApplicationReturnStatus symbols.
STATUS_NAME = {
    Status.SOLVE_SUCCEEDED: "Solve_Succeeded",
    Status.SOLVED_TO_ACCEPTABLE_LEVEL: "Solved_To_Acceptable_Level",
    Status.INFEASIBLE_PROBLEM_DETECTED: "Infeasible_Problem_Detected",
    Status.SEARCH_DIRECTION_BECOMES_TOO_SMALL: "Search_Direction_Becomes_Too_Small",
    Status.DIVERGING_ITERATES: "Diverging_Iterates",
    Status.USER_REQUESTED_STOP: "User_Requested_Stop",
    Status.FEASIBLE_POINT_FOUND: "Feasible_Point_Found",
    Status.MAXIMUM_ITERATIONS_EXCEEDED: "Maximum_Iterations_Exceeded",
    Status.RESTORATION_FAILED: "Restoration_Failed",
    Status.ERROR_IN_STEP_COMPUTATION: "Error_In_Step_Computation",
    Status.MAXIMUM_CPUTIME_EXCEEDED: "Maximum_CpuTime_Exceeded",
    Status.OPTIMIZE_NOT_CALLED: "Optimize_not_called",
    Status.METHOD_NOT_DEFINED: "Method_not_defined",
    Status.NOT_ENOUGH_DEGREES_OF_FREEDOM: "Not_Enough_Degrees_Of_Freedom",
    Status.INVALID_PROBLEM_DEFINITION: "Invalid_Problem_Definition",
    Status.INVALID_OPTION: "Invalid_Option",
    Status.INVALID_NUMBER_DETECTED: "Invalid_Number_Detected",
    Status.UNRECOVERABLE_EXCEPTION: "Unrecoverable_Exception",
    Status.INSUFFICIENT_MEMORY: "Insufficient_Memory",
    Status.INTERNAL_ERROR: "Internal_Error",
}


def status_name(code: int) -> str:
    """Name for an integer status code (unknown codes stringified)."""
    try:
        return STATUS_NAME[Status(int(code))]
    except ValueError:
        return f"Unknown_Status_{int(code)}"


def is_success(code: int) -> bool:
    """Locally-solved statuses (codes 0, 1, 6)."""
    return int(code) in (
        Status.SOLVE_SUCCEEDED,
        Status.SOLVED_TO_ACCEPTABLE_LEVEL,
        Status.FEASIBLE_POINT_FOUND,
    )
