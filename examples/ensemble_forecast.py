"""Ensemble forecast with perturbed initial conditions
(reference: examples/Ensemble_forecast.ipynb), adapted to pySPEEDY-TPU.

Shows both the reference-style per-member API and the batched
fast path.
"""

from datetime import datetime

import numpy as np

from pyspeedy_tpu import SpeedyEns
from pyspeedy_tpu.callbacks import DiagnosticCheck, ModelCheckpoint

number_of_members = 4
start_date = datetime(1980, 1, 1)
end_date = datetime(1980, 1, 8)

model_ens = SpeedyEns(number_of_members, start_date=start_date,
                      end_date=end_date)

rng = np.random.default_rng(42)
for member in model_ens:
    member.set_bc()
    # Gaussian IC perturbation of the temperature field, then push the grid
    # fields back to spectral space (the reference's perturbation idiom).
    t = member["t_grid"]
    member["t_grid"] = t + rng.normal(0.0, 0.01, t.shape)
    member.grid2spectral()

checkpoints = ModelCheckpoint(interval=36,
                              variables=("u_grid", "t_grid"))
model_ens.run(callbacks=[DiagnosticCheck(interval=36), checkpoints])

ens_ds = checkpoints.dataframe
print(ens_ds)

# Ensemble spread of surface temperature at the final checkpoint:
t = ens_ds["t"].data  # (time, ens, lev, lat, lon)
spread = t[-1].std(axis=0)[-1]
print("surface T spread [K]: mean %.4f max %.4f" % (spread.mean(),
                                                    spread.max()))
