"""Physical and code constants (port of `ngravs_tpu/constants.py`).

The constant set of the reference GADGET-2.0.7-ngravs code (allvars.h:25-125
and ngravs.c:42-46).  All cgs values match the reference so that unit
conversions agree to the last digit.
"""

# --- Integer timeline ------------------------------------------------------
# The whole simulated timespan is mapped onto [0, TIMEBASE] where TIMEBASE is a
# power of two; individual timesteps are power-of-two subdivisions
# (reference: allvars.h:25).
TIMEBASE = 1 << 28

# --- Physical constants (cgs) — reference allvars.h:61-80 ------------------
GRAVITY_CGS = 6.672e-8        # gravitational constant
SOLAR_MASS = 1.989e33
SOLAR_LUM = 3.826e33
RAD_CONST = 7.565e-15
AVOGADRO = 6.0222e23
BOLTZMANN = 1.3806e-16
GAS_CONST = 8.31425e7
C_LIGHT = 2.9979e10
PLANCK = 6.6262e-27
CM_PER_MPC = 3.085678e24
PROTONMASS = 1.6726e-24
ELECTRONMASS = 9.10953e-28
THOMPSON = 6.65245e-25
ELECTRONCHARGE = 4.8032e-10
HUBBLE_CGS = 3.2407789e-18    # Hubble constant in h/sec
SEC_PER_MEGAYEAR = 3.155e13
SEC_PER_YEAR = 3.155e7
HYDROGEN_MASSFRAC = 0.76

# --- Gas physics -----------------------------------------------------------
GAMMA = 5.0 / 3.0             # adiabatic index (reference allvars.h:52)
GAMMA_MINUS1 = GAMMA - 1.0

# --- SPH cubic-spline kernel coefficients (3D) — allvars.h:107-117 ---------
KERNEL_COEFF_1 = 2.546479089470
KERNEL_COEFF_2 = 15.278874536822
KERNEL_COEFF_3 = 45.836623610466
KERNEL_COEFF_4 = 30.557749073644
KERNEL_COEFF_5 = 5.092958178941
KERNEL_COEFF_6 = -15.278874536822
NORM_COEFF = 4.188790204786   # 4/3 pi

# --- TreePM split ----------------------------------------------------------
ASMTH = 1.25  # long/short-range split scale in FFT mesh cells (allvars.h:83)
RCUT = 4.5    # short-range cutoff in units of ASMTH (allvars.h:87)

# --- Neighbour search ------------------------------------------------------
MAX_NGB = 20000
MAXITER = 150   # max smoothing-length iterations (allvars.h:97)

# --- ngravs built-in law parameters — reference ngravs.c:42-46 -------------
YUKAWA_IMASS = 60.0    # inverse Yukawa screening length, in units of 1/BoxSize
BAM_EPSILON = 1.31e-6  # BAM ("supermacho") internal scale parameter

# Plummer-equivalent softening -> spline softening length h
# (reference gravtree.c:514-515: ForceSoftening = 2.8 * Plummer softening)
SOFTFAC_SPLINE = 2.8

# Number of particle types carried by the Gadget snapshot format
N_TYPES = 6
