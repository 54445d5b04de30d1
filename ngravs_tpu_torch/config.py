"""Runtime configuration.

Collapses the reference's three configuration surfaces into one runtime object:
 1. compile-time Makefile defines (Makefile.reference:9-135),
 2. the ~60-tag runtime parameterfile (begrun.c:283-780),
 3. the code-as-config force wiring (ngravs.c:64).

Port of `ngravs_tpu/config.py`: the same fields, tags and defaults, so a
parameterfile means the same run in both packages.  `read_parameter_file`
parses stock Gadget parameterfiles (tag/value text with %, ; and # comments),
so the shipped Configuration.reference works unmodified.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from .constants import N_TYPES

# Type names in Gadget order, used for per-type parameter tags
TYPE_NAMES = ("Gas", "Halo", "Disk", "Bulge", "Stars", "Bndry")


@dataclass
class SimulationConfig:
    # --- Relevant files (begrun.c parameterfile tags) ---
    init_cond_file: str = ""
    # empty = no log files and snapshots fall back to a temp directory;
    # stock parameter files always set OutputDir explicitly (begrun.c:356)
    output_dir: str = ""
    snapshot_file_base: str = "snapshot"
    restart_file: str = "restart"
    energy_file: str = "energy.txt"
    info_file: str = "info.txt"
    timings_file: str = "timings.txt"
    cpu_file: str = "cpu.txt"
    output_list_filename: str = ""

    # --- CPU limits ---
    time_limit_cpu: float = 36000.0
    resubmit_on: int = 0
    resubmit_command: str = ""
    cpu_time_bet_restart_file: float = 36000.0

    # --- Code options ---
    ic_format: int = 1
    snap_format: int = 1
    comoving_integration: bool = False
    type_of_timestep_criterion: int = 0
    output_list_on: bool = False
    periodic: bool = False           # PeriodicBoundariesOn / -DPERIODIC

    # --- Characteristics of run ---
    time_begin: float = 0.0
    time_max: float = 1.0
    omega0: float = 0.0
    omega_lambda: float = 0.0
    omega_baryon: float = 0.0
    hubble_param: float = 1.0
    box_size: float = 0.0

    # --- Output frequency ---
    time_bet_snapshot: float = 0.1
    time_of_first_snapshot: float = 0.0
    time_bet_statistics: float = 0.05
    num_files_per_snapshot: int = 1
    num_files_written_in_parallel: int = 1

    # --- Accuracy of time integration ---
    err_tol_int_accuracy: float = 0.025
    courant_fac: float = 0.15
    max_size_timestep: float = 0.01
    min_size_timestep: float = 0.0
    max_rms_displacement_fac: float = 0.2

    # --- Tree / force accuracy ---
    err_tol_theta: float = 0.5
    type_of_opening_criterion: int = 1
    err_tol_force_acc: float = 0.005
    tree_domain_update_frequency: float = 0.1

    # --- SPH ---
    des_num_ngb: int = 50
    max_num_ngb_deviation: float = 2
    art_bulk_visc_const: float = 0.8
    init_gas_temp: float = 0.0
    min_gas_temp: float = 0.0
    min_gas_hsml_fractional: float = 0.25

    # --- Memory (kept for parameterfile compatibility; sizes are static) ---
    part_alloc_factor: float = 1.5
    tree_alloc_factor: float = 0.8
    buffer_size: float = 25.0

    # --- Units ---
    unit_length_in_cm: float = 3.085678e21       # 1 kpc
    unit_mass_in_g: float = 1.989e43             # 1e10 Msun
    unit_velocity_in_cm_per_s: float = 1e5       # 1 km/s
    gravity_constant_internal: float = 0.0

    # --- Softening (Plummer-equivalent, per type) ---
    softening: tuple = (0.0, 1.0, 0.4, 1.0, 1.0, 1.0)
    softening_max_phys: tuple = (0.0, 1.0, 0.4, 1.0, 1.0, 1.0)

    # --- ngravs: gravity-type binding per particle type (Gravity<Type> tags,
    #     begrun.c:520-543) and the number of distinct gravities (-DN_GRAVS) ---
    n_gravs: int = 1
    type_to_grav: tuple = (0, 0, 0, 0, 0, 0)
    wiring: str = "newton"      # name of a registered GravityWiring preset
    ngravs_timestep_scale: float = 1.0   # -DNGRAVS_TIMESTEP_SCALE
    ngravs_accumulator: bool = False     # -DNGRAVS_ACCUMULATOR
    ngravs_l3violation: bool = False     # -DNGRAVS_L3VIOLATION
    ngravs_treepm_xition_check: bool = False  # -DNGRAVS_TREEPM_XITION_CHECK:
    # dump per-pair TreePM transition tables to OutputDir for plotting

    # --- TreePM (-DPMGRID) ---
    pmgrid: int = 0              # 0 = pure tree
    ntab: int = 2048             # short-range transition table length (-DNTAB)
    ngravs_en: int = 64          # Ewald table resolution (-DNGRAVS_EN)
    asmth: float = 1.25          # -DASMTH override
    rcut: float = 4.5            # -DRCUT override
    # PM gradient: "fd4" = the reference's 4th-order finite difference
    # (pm_periodic.c:686-726); "spectral" = exact ik differentiation in k
    # space (3 inverse FFTs per convolution round instead of 1, but no
    # stencil error — the large-r TreePM accuracy limiter)
    pm_gradient: str = "fd4"
    # PM grid interlacing: average a half-cell-staggered second CIC
    # assignment/readout pair in k space, cancelling odd-image aliasing
    # (the near-grid anisotropy floor at the TreePM transition).  2x FFT
    # cost; no reference analog (pm_periodic.c uses a single grid)
    pm_interlace: bool = False

    # --- Integration mode flags (compile-time in the reference) ---
    synchronization: bool = True  # -DSYNCHRONIZATION (default mode)
    # -DFLEXSTEPS (timestep.c:140-231): spread particles over timestep
    # phases via an ID-keyed random group so kick load stays flat instead
    # of spiking at power-of-two sync points; overrides SYNCHRONIZATION
    flexsteps: bool = False
    make_glass: int = 0           # -DMAKEGLASS=<N>
    force_test: float = 0.0       # -DFORCETEST=<fraction>
    # -DCOMPUTE_POTENTIAL_ENERGY: refresh the potential of ALL particles
    # right before each energy_statistics() (run.c:52-59) so energy.txt's
    # potential columns are synchronous rather than per-particle stale
    compute_potential_energy: bool = False
    # -DOUTPUTPOTENTIAL: write the POT block into snapshots, refreshing all
    # potentials first (savepositions, io.c:41-49)
    output_potential: bool = False
    # -DOUTPUTACCELERATION / -DOUTPUTCHANGEOFENTROPY / -DOUTPUTTIMESTEP:
    # extra snapshot blocks ACCE / ENDT / TSTP (io.c:311-353)
    output_acceleration: bool = False
    output_change_of_entropy: bool = False
    output_timestep: bool = False
    # -DLONGIDS: 64-bit particle IDs in snapshot ID blocks (io.c:131-135)
    longids: bool = False
    # -DISOTHERM_EQS: gas behaves isothermally — GAMMA=1, the entropy
    # variable holds u (= c_s^2) and never changes (allvars.h:49-53,
    # read_ic.c:121-132, init.c:170-176, begrun.c:187-192)
    isotherm_eqs: bool = False
    # -DNOGRAVITY: gravity off entirely; active particles get zero
    # GravAccel (gravtree.c:368-374, longrange.c:69, potential.c:26)
    no_gravity: bool = False
    # -DSELECTIVE_NO_GRAVITY=<mask>: particle types whose bit is set in the
    # mask are excluded as tree-force targets (they remain sources;
    # gravtree.c:86-90,360-364)
    selective_no_gravity: int = 0
    # -DSPH_BND_PARTICLES: particles with ID == 0 are fixed boundary/wall
    # particles — hydro acceleration and entropy change forced to zero
    # (hydra.c:321-328)
    sph_bnd_particles: bool = False
    # -DNOVISCOSITYLIMITER: drop the cap on the viscous pair acceleration
    # (hydra.c:511-519)
    no_viscosity_limiter: bool = False
    # -DNOPMSTEPADJUSTMENT: the long-range PM step uses MaxSizeTimestep
    # instead of the RMS-displacement constraint (timestep.c:63-68)
    no_pmstep_adjustment: bool = False
    # -DNOSTOP_WHEN_BELOW_MINTIMESTEP: clamp to MinSizeTimestep silently
    # instead of stopping the run (timestep.c:531-556)
    nostop_when_below_mintimestep: bool = False
    # -DLONG_X/Y/Z (Makefile.reference:118-120): stretch the periodic box
    # per axis to BoxSize*long_*; SPH wraps use the per-axis sizes
    # (ngb.c:22-49, predict.c:114-122).  Gravity must be off, like the
    # reference (begrun.c:766-774)
    long_x: float = 1.0
    long_y: float = 1.0
    long_z: float = 1.0
    # -DTWODIMS (Makefile.reference:121): 2D SPH — 2D-normalized kernel
    # (allvars.h:117-125), column densities divided by the z thickness
    # (density.c:492-496), 2D smoothing-length init (init.c:245-251).
    # NOGRAVITY only, all z coordinates must be equal (main.c:769-772)
    twodims: bool = False
    # -DPSEUDOSYMMETRIC (timestep.c:202-238): when a particle's timestep
    # changes, flip it probabilistically based on a first-order prediction
    # of the acceleration so the step sequence is time-symmetric on
    # average (reduces secular drift of the leapfrog); non-gas only,
    # ignored under FLEXSTEPS
    pseudosymmetric: bool = False
    # -DADAPTIVE_GRAVSOFT_FORGAS: gas uses its SPH smoothing length as the
    # gravitational (spline) softening; tree nodes track the member maximum
    # (forcetree.c:457-461,522,709; gravtree.c:135-138) and the gas timestep
    # criterion uses Hsml/2.8 as the Plummer-equivalent (timestep.c:497-500)
    adaptive_gravsoft_forgas: bool = False
    # When a run is resumed with a larger TimeMax, the integer timeline is
    # rescaled by power-of-two halvings (readjust_timebase, begrun.c:821-864)
    # and afterwards covers [time_begin, timeline_time_max] >= time_max; the
    # run still terminates at time_max.  0 = timeline ends exactly at
    # time_max (the normal case).
    timeline_time_max: float = 0.0

    # --- execution controls (new; no reference analog) ---
    dtype: str = "float32"        # compute dtype for particle state
    accum_dtype: str = "float32"  # accumulation dtype for force sums
    solver: str = "auto"          # "auto" | "tree" (BH octree) | "direct"
    # direct/tree crossover: "auto" uses the exact O(N^2) sweep (zero
    # force error) up to this particle count and the octree above it.  The
    # default is the JAX package's, chosen there for a TPU; it has not been
    # re-measured for this port.  No reference analog.
    direct_crossover: int = 131072
    tree_depth: int = 9           # octree depth (Morton levels, <= 10)
    tree_bucket_size: int = 32    # leaf bucket size for the octree
    tree_group_size: int = 256    # targets per walk group
    tree_node_list_cap: int = 4096   # per-block accepted-node list cap
    tree_leaf_list_cap: int = 8192   # per-block leaf list cap
    tree_frontier_cap: int = 2048    # per-block frontier cap
    tree_block_batch: int = 32       # blocks walked per batched device call
    # fused walk (ops/walk.py): per-block caps, grown on measured
    # overflow like TreeAllocFactor (forcetree.c:3176)
    walk_group_size: int = 64        # targets per Morton-contiguous block
    walk_batch_blocks: int = 128     # blocks per traversal batch
    # initial caps: deliberately modest — the solver clamps them to
    # theoretical maxima for small N and grows them to measured demand on
    # overflow
    walk_ent_cap: int = 2048         # per-BLOCK opened leaf records
    walk_chunk_cap: int = 512        # per-BLOCK leaf 8-row chunks
    walk_mono_cap: int = 1024        # per-BLOCK accepted monopole octets
    walk_frontier_cap: int = 4096    # per-BLOCK per-level frontier slots
    walk_ec: int = 512               # eval chunk length (sources per step)
    mesh_shape: Optional[tuple] = None  # device mesh (n_shards,) or None

    # ------------------------------------------------------------------
    def __post_init__(self):
        self.softening = tuple(float(s) for s in self.softening)
        self.softening_max_phys = tuple(float(s) for s in self.softening_max_phys)
        self.type_to_grav = tuple(int(g) for g in self.type_to_grav)
        if len(self.type_to_grav) != N_TYPES:
            raise ValueError("type_to_grav must have 6 entries")
        if max(self.type_to_grav) >= self.n_gravs:
            raise ValueError(
                f"type_to_grav {self.type_to_grav} references gravity >= n_gravs={self.n_gravs}")
        if self.pmgrid and not self.periodic:
            # reference: ngravs refuses PM without PERIODIC (ngravs_core.c:235-247)
            raise ValueError("pmgrid requires periodic boundaries (as in the reference)")
        if self.pmgrid and self.type_to_grav[0] != 0:
            # gas must be gravity 0 under PMGRID (ngravs_core.c:255-261)
            raise ValueError("gas must be bound to gravity 0 when pmgrid is enabled")
        stretched = (self.long_x, self.long_y, self.long_z) != (1.0, 1.0, 1.0)
        if (stretched or self.twodims) and not self.no_gravity:
            # the reference refuses LONG_X/Y/Z (and documents TWODIMS)
            # without NOGRAVITY (begrun.c:766-774, main.c:769-772)
            raise ValueError(
                "long_x/long_y/long_z and twodims require no_gravity=True, "
                "as in the reference (begrun.c:766-774)")

    def replace(self, **kw) -> "SimulationConfig":
        return dataclasses.replace(self, **kw)

    # adiabatic index (reference allvars.h:49-53): 5/3, or 1 under
    # -DISOTHERM_EQS; every gamma-dependent formula reads these so the
    # isothermal mode is a pure config switch
    @property
    def tree_box_size(self) -> float:
        """Scalar box for octree construction: 0 (use the particle bbox)
        when the box is stretched per axis, since the tree then only serves
        the SPH neighbor search (gravity is off under LONG_X/Y/Z)."""
        if not self.periodic or self.box_size <= 0:
            return 0.0
        if (self.long_x, self.long_y, self.long_z) != (1.0, 1.0, 1.0):
            return 0.0
        return self.box_size

    @property
    def box_sizes(self) -> tuple:
        """Per-axis periodic box lengths (BoxSize * LONG_X/Y/Z);
        (0,0,0) when not periodic."""
        if not self.periodic or self.box_size <= 0:
            return (0.0, 0.0, 0.0)
        return (self.box_size * self.long_x, self.box_size * self.long_y,
                self.box_size * self.long_z)

    @property
    def gamma(self) -> float:
        return 1.0 if self.isotherm_eqs else 5.0 / 3.0

    @property
    def gamma_minus1(self) -> float:
        return self.gamma - 1.0


# --------------------------------------------------------------------------
# Parameterfile parsing (reference begrun.c:283-780)
# --------------------------------------------------------------------------

# tag -> (config field, converter)
_F = float
_I = int
_S = str
_B = lambda v: bool(int(v))

_TAG_MAP = {
    "InitCondFile": ("init_cond_file", _S),
    "OutputDir": ("output_dir", _S),
    "SnapshotFileBase": ("snapshot_file_base", _S),
    "RestartFile": ("restart_file", _S),
    "EnergyFile": ("energy_file", _S),
    "InfoFile": ("info_file", _S),
    "TimingsFile": ("timings_file", _S),
    "CpuFile": ("cpu_file", _S),
    "OutputListFilename": ("output_list_filename", _S),
    "TimeLimitCPU": ("time_limit_cpu", _F),
    "ResubmitOn": ("resubmit_on", _I),
    "ResubmitCommand": ("resubmit_command", _S),
    "CpuTimeBetRestartFile": ("cpu_time_bet_restart_file", _F),
    # compile-time defines in the reference; runtime flags here
    "ComputePotentialEnergy": ("compute_potential_energy", _B),
    "OutputPotential": ("output_potential", _B),
    "OutputAcceleration": ("output_acceleration", _B),
    "OutputChangeOfEntropy": ("output_change_of_entropy", _B),
    "OutputTimestep": ("output_timestep", _B),
    "LongIds": ("longids", _B),
    "IsothermEqs": ("isotherm_eqs", _B),
    "NoGravity": ("no_gravity", _B),
    "SelectiveNoGravity": ("selective_no_gravity", _I),
    "SphBndParticles": ("sph_bnd_particles", _B),
    "NoViscosityLimiter": ("no_viscosity_limiter", _B),
    "NoPmStepAdjustment": ("no_pmstep_adjustment", _B),
    "NoStopBelowMinTimestep": ("nostop_when_below_mintimestep", _B),
    "AdaptiveGravsoftForGas": ("adaptive_gravsoft_forgas", _B),
    "PseudoSymmetric": ("pseudosymmetric", _B),
    "LongX": ("long_x", _F),
    "LongY": ("long_y", _F),
    "LongZ": ("long_z", _F),
    "TwoDims": ("twodims", _B),
    "ICFormat": ("ic_format", _I),
    "SnapFormat": ("snap_format", _I),
    "ComovingIntegrationOn": ("comoving_integration", _B),
    "TypeOfTimestepCriterion": ("type_of_timestep_criterion", _I),
    "OutputListOn": ("output_list_on", _B),
    "PeriodicBoundariesOn": ("periodic", _B),
    "TimeBegin": ("time_begin", _F),
    "TimeMax": ("time_max", _F),
    "Omega0": ("omega0", _F),
    "OmegaLambda": ("omega_lambda", _F),
    "OmegaBaryon": ("omega_baryon", _F),
    "HubbleParam": ("hubble_param", _F),
    "BoxSize": ("box_size", _F),
    "TimeBetSnapshot": ("time_bet_snapshot", _F),
    "TimeOfFirstSnapshot": ("time_of_first_snapshot", _F),
    "TimeBetStatistics": ("time_bet_statistics", _F),
    "NumFilesPerSnapshot": ("num_files_per_snapshot", _I),
    "NumFilesWrittenInParallel": ("num_files_written_in_parallel", _I),
    "ErrTolIntAccuracy": ("err_tol_int_accuracy", _F),
    "CourantFac": ("courant_fac", _F),
    "MaxSizeTimestep": ("max_size_timestep", _F),
    "MinSizeTimestep": ("min_size_timestep", _F),
    "MaxRMSDisplacementFac": ("max_rms_displacement_fac", _F),
    "ErrTolTheta": ("err_tol_theta", _F),
    "TypeOfOpeningCriterion": ("type_of_opening_criterion", _I),
    "ErrTolForceAcc": ("err_tol_force_acc", _F),
    "TreeDomainUpdateFrequency": ("tree_domain_update_frequency", _F),
    "DesNumNgb": ("des_num_ngb", _I),
    "MaxNumNgbDeviation": ("max_num_ngb_deviation", _F),
    "ArtBulkViscConst": ("art_bulk_visc_const", _F),
    "InitGasTemp": ("init_gas_temp", _F),
    "MinGasTemp": ("min_gas_temp", _F),
    "MinGasHsmlFractional": ("min_gas_hsml_fractional", _F),
    "PartAllocFactor": ("part_alloc_factor", _F),
    "TreeAllocFactor": ("tree_alloc_factor", _F),
    "BufferSize": ("buffer_size", _F),
    "UnitLength_in_cm": ("unit_length_in_cm", _F),
    "UnitMass_in_g": ("unit_mass_in_g", _F),
    "UnitVelocity_in_cm_per_s": ("unit_velocity_in_cm_per_s", _F),
    "GravityConstantInternal": ("gravity_constant_internal", _F),
}


def read_parameter_file(path: str, **overrides) -> SimulationConfig:
    """Parse a Gadget parameterfile into a SimulationConfig.

    Accepts the stock tag/value format with %, ;, # comments.  Per-type tags
    (Softening<Type>, Softening<Type>MaxPhys, Gravity<Type>) are folded into
    tuple fields.  Unknown tags raise, matching the reference's strictness
    (begrun.c:693-698), except tags the rebuild intentionally absorbs.
    """
    kv = {}
    softening = [0.0] * N_TYPES
    softening_max = [0.0] * N_TYPES
    type_to_grav = [0] * N_TYPES
    saw_grav = False

    with open(path) as f:
        for raw in f:
            # strip comments: %, ; and # start a comment anywhere in the line
            line = raw
            for c in "%;#":
                idx = line.find(c)
                if idx >= 0:
                    line = line[:idx]
            parts = line.split()
            if not parts:
                continue
            tag, val = parts[0], (parts[1] if len(parts) > 1 else "")
            handled = False
            for i, tname in enumerate(TYPE_NAMES):
                if tag == f"Softening{tname}":
                    softening[i] = float(val); handled = True
                elif tag == f"Softening{tname}MaxPhys":
                    softening_max[i] = float(val); handled = True
                elif tag == f"Gravity{tname}":
                    type_to_grav[i] = int(val); saw_grav = True; handled = True
            if handled:
                continue
            if tag in _TAG_MAP:
                fieldname, conv = _TAG_MAP[tag]
                kv[fieldname] = conv(val)
            else:
                raise ValueError(f"unknown parameterfile tag {tag!r} in {path}")

    kv["softening"] = tuple(softening)
    kv["softening_max_phys"] = tuple(softening_max)
    if saw_grav:
        kv["type_to_grav"] = tuple(type_to_grav)
        kv.setdefault("n_gravs", max(type_to_grav) + 1)
    kv.update(overrides)
    return SimulationConfig(**kv)


def write_usedvalues(cfg: SimulationConfig, path: str):
    """Echo every effective parameter to `<paramfile>-usedvalues`
    (begrun.c:619: the reference writes the parsed tag/value pairs back out
    so a run's configuration is self-documenting)."""
    with open(path, "w") as f:
        for tag, (field, _conv) in _TAG_MAP.items():
            v = getattr(cfg, field)
            if isinstance(v, bool):
                v = int(v)
            f.write(f"{tag:<35s} {v}\n")
        for i, tname in enumerate(TYPE_NAMES):
            f.write(f"{'Softening' + tname:<35s} {cfg.softening[i]}\n")
            f.write(f"{'Softening' + tname + 'MaxPhys':<35s} "
                    f"{cfg.softening_max_phys[i]}\n")
            f.write(f"{'Gravity' + tname:<35s} {cfg.type_to_grav[i]}\n")
