"""Seeded float32 inputs of five kinds, signs mixed, for the tests of
``w8_gemm.w8f32_gemm``'s split of x into three bf16 terms: on the CPU
(``tests/test_torch_w8f32.py``) and on the card
(``tests/test_torch_parallel_cuda.py``). Imports no JAX."""
import numpy as np

FLT_MAX = float(np.finfo(np.float32).max)
FAMILIES = ["normal", "large", "tiny", "subnormal", "mixed"]


def family(name: str, n: int = 4096) -> np.ndarray:
    """n float32 values of one kind (n >= 4 for "large", which starts with
    float32's largest values and two that round past bf16's)."""
    rng = np.random.default_rng(FAMILIES.index(name))
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    if name == "normal":
        x = rng.standard_normal(n)
    elif name == "large":  # up to float32's largest, some rounding past bf16's
        x = sign * np.exp(rng.uniform(np.log(1e30), np.log(FLT_MAX), n))
        x[:4] = [FLT_MAX, -FLT_MAX, 3.3961e38, -3.3960e38]
    elif name == "tiny":  # normal floats from 2**-126 to 1e-20
        x = sign * np.exp(rng.uniform(np.log(2.0 ** -126), np.log(1e-20), n))
    elif name == "subnormal":
        x = sign * rng.integers(1, 2 ** 23, n) * 2.0 ** -149
    elif name == "mixed":  # every scale at once, with zeros of both signs
        x = sign * np.exp(rng.uniform(np.log(1e-44), np.log(1e38), n))
        x[::97], x[1::97] = 0.0, -0.0
    else:
        raise ValueError(name)
    return x.astype(np.float32)
