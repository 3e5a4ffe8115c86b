"""K3 fp32 (flash backward, 3xTF32) share of its roofline at the TF32 peak on the operations themselves."""

from h100_bench.harness import readers as R


def read(m):
    return R.k3_train_roofline(m, fp32=True)
