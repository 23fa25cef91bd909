"""Cart-pole swing-up through the port's public API, at the sizes of
`cartpole-n100.json`."""


def build(cfg: dict) -> dict:
    from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem  # noqa: PLC0415

    problem, X, U = cart_pole_problem(N=int(cfg["N"]), total_time=float(cfg["total_time"]),
                                      u_max=float(cfg["u_max"]), d_max=float(cfg["d_max"]))
    return {"problem": problem, "outputs": {"X": X, "U": U}}
