"""Physical constants.

Mirrors the reference's scalar constants (ROMS/Modules/mod_scalars.F:283-792)
so that validation cases reproduce the reference numerics.
"""

import math

# Gravity and planetary constants (mod_scalars.F:431-441)
g = 9.81                    # m/s^2
Cp = 3985.0                 # J/kg/degC   specific heat of seawater
Eradius = 6371315.0         # m           Earth radius
rho0_default = 1025.0       # kg/m^3      Boussinesq reference density

pi = math.pi
deg2rad = pi / 180.0
rad2deg = 180.0 / pi
day2sec = 86400.0
sec2day = 1.0 / 86400.0

# Rotation rate used by the BENCHMARK case's spherical Coriolis
# (ana_grid.h:867-872): 2*Omega with sidereal correction.
omega_benchmark = 2.0 * (2.0 * pi * 366.25 / 365.25) / 86400.0

# Power-law fast-time filter shape parameters (mod_scalars.F:310-312)
Falpha = 2.0
Fbeta = 4.0
Fgamma = 0.284
