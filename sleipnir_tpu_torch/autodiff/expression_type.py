"""Expression linearity classification.

The load-bearing Sleipnir idea (reference autodiff/expression_type.hpp:15-27,
benchmarks/README.md "How we improved performance"): every expression carries
its linearity class. The Problem DSL uses the classification to choose a
solver (no-op / Newton / SQP / interior-point), and derivative evaluation of
CONSTANT/LINEAR blocks is hoisted out of the solver iteration loop.
"""

import enum


class ExpressionType(enum.IntEnum):
    """Linearity class of an expression, ordered by increasing nonlinearity.

    Mirrors reference autodiff/expression_type.hpp:15-27.
    """

    #: There is no expression (e.g., a problem with no cost function).
    NONE = 0
    #: The expression is a constant.
    CONSTANT = 1
    #: The expression is composed of linear and lower-order operators.
    LINEAR = 2
    #: The expression is composed of quadratic and lower-order operators.
    QUADRATIC = 3
    #: The expression is composed of nonlinear and lower-order operators.
    NONLINEAR = 4

    def __str__(self) -> str:
        return {
            ExpressionType.NONE: "none",
            ExpressionType.CONSTANT: "constant",
            ExpressionType.LINEAR: "linear",
            ExpressionType.QUADRATIC: "quadratic",
            ExpressionType.NONLINEAR: "nonlinear",
        }[self]


def mul_type(lhs: ExpressionType, rhs: ExpressionType) -> ExpressionType:
    """Linearity of a product (reference autodiff/expression.hpp:155-205).

    constant·T → T; linear·linear → quadratic; anything of higher combined
    polynomial degree than 2 → nonlinear.
    """
    if lhs == ExpressionType.NONE or rhs == ExpressionType.NONE:
        return ExpressionType.NONE
    if lhs == ExpressionType.CONSTANT:
        return rhs
    if rhs == ExpressionType.CONSTANT:
        return lhs
    # Polynomial degree addition: LINEAR=1, QUADRATIC=2, NONLINEAR=∞
    if lhs == ExpressionType.NONLINEAR or rhs == ExpressionType.NONLINEAR:
        return ExpressionType.NONLINEAR
    degree = (int(lhs) - 1) + (int(rhs) - 1)
    if degree <= 2:
        return ExpressionType(degree + 1)
    return ExpressionType.NONLINEAR


def add_type(lhs: ExpressionType, rhs: ExpressionType) -> ExpressionType:
    """Linearity of a sum/difference (reference autodiff/expression.hpp:262)."""
    return max(lhs, rhs)


def div_type(lhs: ExpressionType, rhs: ExpressionType) -> ExpressionType:
    """Linearity of a quotient (reference autodiff/expression.hpp:207-242)."""
    if lhs == ExpressionType.NONE or rhs == ExpressionType.NONE:
        return ExpressionType.NONE
    if rhs == ExpressionType.CONSTANT:
        return lhs
    return ExpressionType.NONLINEAR


def pow_type(base: ExpressionType, power: float) -> ExpressionType:
    """Linearity of a power with constant exponent.

    Reference autodiff/expression.hpp:1740-1748: pow(linear, 2) is QUADRATIC;
    other non-{0,1} exponents of non-constant bases are NONLINEAR.
    """
    if base == ExpressionType.NONE:
        return ExpressionType.NONE
    if base == ExpressionType.CONSTANT:
        return ExpressionType.CONSTANT
    if power == 0:
        return ExpressionType.CONSTANT
    if power == 1:
        return base
    if power == 2 and base == ExpressionType.LINEAR:
        return ExpressionType.QUADRATIC
    return ExpressionType.NONLINEAR


def nonlinear_type(arg: ExpressionType) -> ExpressionType:
    """Linearity of a transcendental function application."""
    if arg == ExpressionType.NONE:
        return ExpressionType.NONE
    if arg == ExpressionType.CONSTANT:
        return ExpressionType.CONSTANT
    return ExpressionType.NONLINEAR
