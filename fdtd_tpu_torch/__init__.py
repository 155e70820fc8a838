"""fdtd_tpu_torch: the FDTD microwave-oven solver on PyTorch and CUDA.

A port of :mod:`fdtd_tpu` (JAX/Pallas, kept beside it as the reference) to
an NVIDIA H100.  It imports neither JAX nor :mod:`fdtd_tpu`.  Ported: the
cavity's main path (the ``params.txt`` parser, the Yee leapfrog step with
the TE10 port source and the TE101 validation seed, snapshots, energy
logs, checkpoints and the CLI, ``python -m fdtd_tpu_torch params.txt``),
materials and heating (lossy and heterogeneous-mu_r loads and the SAR
map), the CPML open boundary, Debye media and the frequency-domain
monitors (DFT phasors and probes), spatial sharding, the thermal solve, the
two-way EM <-> thermal coupling with the turntable, design sweeps and the
stability map.  The Yee update runs as hand-written
CUDA kernels for Hopper on CUDA tensors (``csrc/yee_stream.cu``, s steps a
launch, and ``csrc/yee_twopass.cu``, the H and E half-steps, each with its
material, CPML, Debye and DFT variants; ``csrc/dft_accum.cu``, the
per-step DFT sums; built with nvcc at first use), and as plain torch slice
arithmetic on CPU tensors.
"""

from .coupled import CoupledResult, run_coupled, water_debye
from .params import Mode, Params, SourceConfig, load_parameters, num_steps, parse_params_text, time_values
from .state import FieldState, init_validation, update_coefs, zeros
from .thermal import ThermalMaterials, air_thermal, run_thermal, water_thermal
from .turntable import LoadGeometry, geometry_mask, rotate_field

__all__ = [
    "CoupledResult",
    "FieldState",
    "LoadGeometry",
    "Mode",
    "Params",
    "SourceConfig",
    "ThermalMaterials",
    "air_thermal",
    "geometry_mask",
    "init_validation",
    "load_parameters",
    "num_steps",
    "parse_params_text",
    "rotate_field",
    "run_coupled",
    "run_thermal",
    "time_values",
    "update_coefs",
    "water_debye",
    "water_thermal",
    "zeros",
]
