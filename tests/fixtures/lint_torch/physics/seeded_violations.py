"""The port's bdlz-lint test fixture: exactly one seeded violation per
torch rule R2, R3, R4, R5, R7 and R13.

Lives under a ``physics/`` directory on purpose — that puts it in scope
for the directory-scoped rules (R2 and R3 hot paths, R4 magic floats).
Never imported; parsed by the analyzer only (tests/test_torch_lint.py).
"""
import time

import torch

# R5: global torch state written outside backend.py
torch.set_default_dtype(torch.float64)

# R7: bare time.sleep call outside utils/retry.py
time.sleep(0.0)


def hot_kernel(x: torch.Tensor):
    # R2: a Python branch on a tensor-valued test
    if (x > 0.0).any():
        x = x + 1.0
    # R3: a host sync inside a hot path
    z = x.sum().item()
    # R13: a tensor constructor without an explicit dtype
    w = torch.zeros(3)
    # not a finding: the *_like forms inherit their input's dtype
    v = torch.zeros_like(x)
    # R4: magic float in a physics module (belongs in constants.py)
    return torch.sin(x) * 1.6603 + z + w.sum() + v
