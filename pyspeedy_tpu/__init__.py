"""pySPEEDY-TPU: a JAX/XLA reimplementation of the SPEEDY
intermediate-complexity atmospheric general circulation model, with the same
capabilities and Python API surface as aperezhortal/pySPEEDY."""

from pathlib import Path

__version__ = "0.1.0"

PACKAGE_DATA_DIR = Path(__file__).parent / "data"

DEFAULT_OUTPUT_VARS = (
    "u_grid",
    "v_grid",
    "t_grid",
    "q_grid",
    "phi_grid",
    "ps_grid",
)


def example_bc_file():
    """Path to the bundled example boundary-conditions file."""
    return str(PACKAGE_DATA_DIR / "example_bc.nc")


def example_sst_anomaly_file():
    """Path to the bundled example SST anomaly file."""
    return str(PACKAGE_DATA_DIR / "sst_anomaly.nc")


from .params import ModelParams, T30L8  # noqa: E402
from .speedy import Speedy, SpeedyEns, MODEL_STATE_DEF  # noqa: E402,F401
