"""Safe torch.load for external .pth data files.

Counterpart (a copy) of ``pynqs_tpu/utils/torch_io.py``.

The reference's data files (integrals, converted FOCUS MPS state
dicts) are plain tensor/ndarray containers, but they predate torch's
weights_only default and pickle numpy arrays through
``numpy.core.multiarray._reconstruct``.  Loading them with
``weights_only=False`` would execute arbitrary pickle bytecode from an
untrusted file; instead allowlist exactly the benign numpy globals the
files need and keep the weights-only unpickler.
"""

from __future__ import annotations

__all__ = ["safe_torch_load"]


def safe_torch_load(path: str):
    import numpy as np
    import torch

    safe = [np.ndarray, np.dtype]
    # numpy's array reconstructor moved namespaces between np 1.x/2.x;
    # torch keys its allowlist by the object's own module, so register
    # the function under BOTH spellings a pickle may reference (the
    # (obj, "name.as.in.pickle") tuple form).
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        try:
            m = __import__(mod, fromlist=["_reconstruct"])
            safe.append((m._reconstruct, mod + "._reconstruct"))
        except (ImportError, AttributeError):
            pass
    for name in ("Float64DType", "Float32DType", "Int64DType", "Int32DType",
                 "Complex128DType", "Complex64DType", "BoolDType"):
        try:
            import numpy.dtypes as _dts

            safe.append(getattr(_dts, name))
        except (ImportError, AttributeError):
            pass
    with torch.serialization.safe_globals(safe):
        return torch.load(path, map_location="cpu", weights_only=True)
