"""Double-float precision probe on the card.

    python -m sleipnir_tpu_torch.tools.dd_probe               # on the card
    python -m sleipnir_tpu_torch.tools.dd_probe --device cpu  # plain version

The counterpart of `tools/pallas_dd_probe.py`: the same inputs from
`numpy.random.default_rng(0)`, the whole probe run in one kernel launch
(`ops/cuda_dd_probe.probe`), and the same lines: two_sum and two_prod
exactness, add2, mul2 and div2 against float64, and a 13×13 one-hot float32
product against the exact one. A further line gives the error of the same
product in a single TF32 pass of the card's matrix unit, the question the
TPU probe asks of its MXU; it is reported, not checked. On the card it
then runs the plain torch version (`ops/dd.py`) on the same inputs and
requires every output to equal the kernel's bit for bit; it exits
non-zero if one does not.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sleipnir_tpu_torch.ops import cuda_dd_probe, dd

SHAPE = (8, 128)
WIDTH = 13


def probe_inputs(device) -> dict:
    """The TPU probe's inputs, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal(SHAPE)
    b64 = rng.standard_normal(SHAPE) * 10.0 ** rng.uniform(-3, 3, SHAPE)
    P = np.zeros((WIDTH, WIDTH), np.float32)
    perm = rng.permutation(WIDTH)
    P[np.arange(WIDTH), perm] = 1.0
    M64 = rng.standard_normal((WIDTH, WIDTH))

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    ah, al = dd.from_f64(f64(a64))
    bh, bl = dd.from_f64(f64(b64))
    Mh, _ = dd.from_f64(f64(M64))
    return {
        "a64": a64, "b64": b64, "ah": ah, "al": al, "bh": bh, "bl": bl,
        "P": torch.as_tensor(P, device=device), "Mh": Mh,
    }


def run_probe(x: dict, primitive, onehot) -> dict:
    """Every probe case through `primitive(name, *inputs)` and
    `onehot(P, X)`: the kernel wrappers or the plain versions."""
    out = {
        "two_sum": primitive("two_sum", x["ah"], x["bh"]),
        "two_prod": primitive("two_prod", x["ah"], x["bh"]),
    }
    for name in ("add2", "mul2", "div2"):
        out[name] = primitive(name, x["ah"], x["al"], x["bh"], x["bl"])
    out["onehot"] = (onehot(x["P"], x["Mh"]),)
    return out


def run_fused(x: dict):
    """The whole probe in one launch (plain versions on the CPU): the
    outputs as `run_probe` returns them, and the single-pass TF32
    one-hot product."""
    pairs, products = cuda_dd_probe.probe(x["ah"], x["al"], x["bh"], x["bl"], x["P"], x["Mh"])
    out = {name: tuple(pairs[op]) for name, (op, _arity) in cuda_dd_probe.PRIMITIVES.items()}
    out["onehot"] = (products[0],)
    return out, products[1]


def tf32_single_pass_error(x: dict, single) -> float:
    """Max error of the one-hot product in one TF32 pass against the exact
    float64 product."""
    exact = x["P"].cpu().double() @ x["Mh"].cpu().double()
    return float((single.cpu().double() - exact).abs().max())


def plain_primitive(name: str, *inputs):
    return getattr(dd, name)(*inputs)


def error_lines(x: dict, out: dict) -> list[tuple[str, float]]:
    """The TPU probe's error lines, against float64."""

    def f64(t):
        return t.cpu().numpy().astype(np.float64)

    a, b = f64(x["ah"]), f64(x["bh"])
    lines = []
    s, e = out["two_sum"]
    lines.append(("two_sum max err", float(np.abs(f64(s) + f64(e) - (a + b)).max())))
    p, e = out["two_prod"]
    ref = a * b
    rel = np.abs(f64(p) + f64(e) - ref) / np.maximum(np.abs(ref), 1e-30)
    lines.append(("two_prod max rel err", float(rel.max())))
    a64, b64 = x["a64"], x["b64"]
    for name, ref in (("add2", a64 + b64), ("mul2", a64 * b64), ("div2", a64 / b64)):
        h, l = out[name]
        rel = np.abs(f64(h) + f64(l) - ref) / np.maximum(np.abs(ref), 1e-30)
        lines.append((f"{name} max rel err", float(rel.max())))
    exact = f64(x["P"]) @ f64(x["Mh"])
    lines.append(("one-hot dot max err", float(np.abs(f64(out["onehot"][0]) - exact).max())))
    return lines


def bitwise_equal(a: dict, b: dict) -> bool:
    """Every output tensor of two probe runs holds the same bits."""
    return all(
        torch.equal(u.view(torch.int32), v.view(torch.int32))
        for name in a for u, v in zip(a[name], b[name])
    )


def max_abs_diff(a: dict, b: dict) -> float:
    return max(
        float((u.double() - v.double()).abs().max()) for name in a for u, v in zip(a[name], b[name])
    )


def main(argv: list[str] | None = None) -> dict:
    """Run the probe; returns the error lines and, on the card, whether the
    kernels equal the plain version bit for bit."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false; pass --device cpu for the plain version")
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    x = probe_inputs(device)
    out, single = run_fused(x)
    result = {"lines": error_lines(x, out), "tf32_single_pass_max_err": tf32_single_pass_error(x, single)}
    for label, value in result["lines"]:
        print(f"{label}: {value}")
    print(f"one-hot dot in one TF32 pass, max err: {result['tf32_single_pass_max_err']}"
          + ("" if device.type == "cuda" else " (plain model: X truncated to 11 bits)"))
    if device.type != "cuda":
        print("kernel vs plain: not run (the plain version ran; the kernels need the card)")
        return result
    plain = run_probe(x, plain_primitive, dd.onehot_product)
    torch.cuda.synchronize()
    result["bitwise_equal"] = bitwise_equal(out, plain)
    result["max_abs_diff"] = max_abs_diff(out, plain)
    print(f"kernel vs plain: bitwise equal {result['bitwise_equal']}, "
          f"max abs diff {result['max_abs_diff']}")
    if not result["bitwise_equal"]:
        sys.exit("the kernels and the plain version disagree")
    return result


if __name__ == "__main__":
    main()
