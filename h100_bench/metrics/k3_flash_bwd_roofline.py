"""K3 bf16 (flash backward) share of its roofline."""

from h100_bench.harness import readers as R


def read(m):
    return R.k3_train_roofline(m, fp32=False)
