"""Gadget snapshot format 1/2 reader and writer.

Port of `ngravs_tpu/io/gadget_format.py`, which needs only numpy and is
carried over unchanged so both packages read and write the same files.

Numpy implementation of the reference's IC reading (read_ic.c:31-804) and
snapshot writing (io.c:33-1150).  Little-endian only, like the reference
(README.md:63-64).  Format 1 = raw Fortran-77 record blocks; format 2 adds a
4-character block-name header before each block.

Block order (reference `enum iofields`, allvars.h:714-727):
  HEAD(256B), POS(f32 3N), VEL(f32 3N), ID(u32 N; u64 under LONGIDS), MASS
  (f32, only for types with header mass 0 and npart>0), then gas blocks
  U(f32 Ngas), RHO, HSML (RHO/HSML present in snapshots, absent in ICs),
  optional POT(f32 N) / ACCE(f32 3N) / ENDT(f32 Ngas) / TSTP(f32 N)
  (OUTPUTPOTENTIAL / OUTPUTACCELERATION / OUTPUTCHANGEOFENTROPY /
  OUTPUTTIMESTEP, io.c:300-353).

Output is always float32 regardless of internal precision, matching
Makefile.reference:284-287.  LONGIDS (u64 ID blocks) is auto-detected on
read by record size; format-1 trailing optional blocks are identified
positionally with size-based skipping (the reference's own format-1 reader
never reads them back at all, read_ic.c).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
import os
import struct

import numpy as np

N_TYPES = 6
HEADER_BYTES = 256


@dataclass
class SnapshotHeader:
    """256-byte Gadget header (reference io_header, allvars.h:683-708)."""
    npart: np.ndarray = field(default_factory=lambda: np.zeros(N_TYPES, np.int32))
    mass: np.ndarray = field(default_factory=lambda: np.zeros(N_TYPES, np.float64))
    time: float = 0.0
    redshift: float = 0.0
    flag_sfr: int = 0
    flag_feedback: int = 0
    npart_total: np.ndarray = field(default_factory=lambda: np.zeros(N_TYPES, np.uint32))
    flag_cooling: int = 0
    num_files: int = 1
    box_size: float = 0.0
    omega0: float = 0.0
    omega_lambda: float = 0.0
    hubble_param: float = 1.0

    def pack(self) -> bytes:
        buf = struct.pack(
            "<6i6ddd2i6Iii4d",
            *[int(x) for x in self.npart],
            *[float(x) for x in self.mass],
            self.time, self.redshift,
            self.flag_sfr, self.flag_feedback,
            *[int(x) for x in self.npart_total],
            self.flag_cooling, self.num_files,
            self.box_size, self.omega0, self.omega_lambda, self.hubble_param,
        )
        return buf + b"\x00" * (HEADER_BYTES - len(buf))

    @staticmethod
    def unpack(raw: bytes) -> "SnapshotHeader":
        vals = struct.unpack("<6i6ddd2i6Iii4d", raw[: struct.calcsize("<6i6ddd2i6Iii4d")])
        h = SnapshotHeader()
        h.npart = np.array(vals[0:6], np.int32)
        h.mass = np.array(vals[6:12], np.float64)
        h.time, h.redshift = vals[12], vals[13]
        h.flag_sfr, h.flag_feedback = vals[14], vals[15]
        h.npart_total = np.array(vals[16:22], np.uint32)
        h.flag_cooling, h.num_files = vals[22], vals[23]
        h.box_size, h.omega0, h.omega_lambda, h.hubble_param = vals[24:28]
        return h


@dataclass
class SnapshotData:
    """Decoded snapshot: numpy arrays in type-sorted order (gas first)."""
    header: SnapshotHeader
    pos: np.ndarray          # [N,3] f32
    vel: np.ndarray          # [N,3] f32
    pid: np.ndarray          # [N] u32
    mass: np.ndarray         # [N] f32 (expanded from MassTable where needed)
    ptype: np.ndarray        # [N] i32, derived from npart blocks
    u: np.ndarray | None = None       # [Ngas] internal energy
    rho: np.ndarray | None = None
    hsml: np.ndarray | None = None
    pot: np.ndarray | None = None     # [N]   OUTPUTPOTENTIAL
    accel: np.ndarray | None = None   # [N,3] OUTPUTACCELERATION
    dtentr: np.ndarray | None = None  # [Ngas] OUTPUTCHANGEOFENTROPY
    tstp: np.ndarray | None = None    # [N]   OUTPUTTIMESTEP

    @property
    def n(self) -> int:
        return self.pos.shape[0]


class _RecordReader:
    def __init__(self, f, format2: bool):
        self.f = f
        self.format2 = format2

    def next_block(self):
        """Read one F77 record; returns (name_or_None, payload bytes) or None at EOF."""
        name = None
        if self.format2:
            raw = self.f.read(4)
            if len(raw) < 4:
                return None
            (n1,) = struct.unpack("<i", raw)
            namebuf = self.f.read(n1)
            name = namebuf[:4].decode("latin1").strip()
            self.f.read(4)
        raw = self.f.read(4)
        if len(raw) < 4:
            return None
        (n1,) = struct.unpack("<i", raw)
        payload = self.f.read(n1)
        (n2,) = struct.unpack("<i", self.f.read(4))
        if n1 != n2:
            raise IOError(f"corrupt F77 record: lengths {n1} != {n2}")
        return name, payload


def _detect_format(path: str) -> int:
    with open(path, "rb") as f:
        (n1,) = struct.unpack("<i", f.read(4))
    if n1 == 8:
        return 2
    if n1 == HEADER_BYTES:
        return 1
    raise IOError(f"{path}: first record length {n1}, not a Gadget format 1/2 file")


def read_snapshot(path: str, expect_format: int | None = None) -> SnapshotData:
    fmt = _detect_format(path)
    if expect_format and fmt != expect_format:
        raise IOError(f"{path}: detected format {fmt}, expected {expect_format}")
    with open(path, "rb") as f:
        rd = _RecordReader(f, fmt == 2)
        name, payload = rd.next_block()
        header = SnapshotHeader.unpack(payload)
        npart = header.npart.astype(np.int64)
        n = int(npart.sum())
        ngas = int(npart[0])

        blocks = []
        while True:
            blk = rd.next_block()
            if blk is None:
                break
            blocks.append(blk)

        # sequential block semantics for format 1 (names implied by order);
        # each expected entry carries its byte size so optional blocks that
        # are absent are skipped instead of mislabeling what follows
        # MASS present only if some type has header-mass 0 with particles
        n_massblock = sum(int(npart[t]) for t in range(N_TYPES)
                          if npart[t] > 0 and header.mass[t] == 0)
        expected = [("POS", (12 * n,)), ("VEL", (12 * n,)),
                    ("ID", (4 * n, 8 * n))]
        if n_massblock:
            expected.append(("MASS", (4 * n_massblock,)))
        if ngas > 0:
            expected += [("U", (4 * ngas,)), ("RHO", (4 * ngas,)),
                         ("HSML", (4 * ngas,))]
        expected += [("POT", (4 * n,)), ("ACCE", (12 * n,))]
        if ngas > 0:
            expected.append(("ENDT", (4 * ngas,)))
        expected.append(("TSTP", (4 * n,)))

        named = {}
        if fmt == 2:
            for bname, data in blocks:
                named[bname] = data
        else:
            e = 0
            for _, data in blocks:
                while e < len(expected) and len(data) not in expected[e][1]:
                    e += 1
                if e >= len(expected):
                    break
                named[expected[e][0]] = data
                e += 1

        pos = np.frombuffer(named["POS"], "<f4").reshape(n, 3)
        vel = np.frombuffer(named["VEL"], "<f4").reshape(n, 3)
        # LONGIDS: a 64-bit ID block is detected by its record size
        if len(named["ID"]) == 8 * n:
            pid = np.frombuffer(named["ID"], "<u8")
        else:
            pid = np.frombuffer(named["ID"], "<u4")

        ptype = np.repeat(np.arange(N_TYPES, dtype=np.int32), npart)

        mass = np.empty(n, np.float32)
        if "MASS" in named:
            mblock = np.frombuffer(named["MASS"], "<f4")
        else:
            mblock = np.empty(0, np.float32)
        mi = 0
        off = 0
        for t in range(N_TYPES):
            cnt = int(npart[t])
            if cnt == 0:
                continue
            if header.mass[t] == 0:
                mass[off:off + cnt] = mblock[mi:mi + cnt]
                mi += cnt
            else:
                mass[off:off + cnt] = header.mass[t]
            off += cnt

        def _opt(nm, cnt):
            if nm in named and len(named[nm]) == cnt * 4:
                return np.frombuffer(named[nm], "<f4")
            return None

        accel = _opt("ACCE", 3 * n)
        return SnapshotData(
            header=header, pos=pos, vel=vel, pid=pid, mass=mass, ptype=ptype,
            u=_opt("U", ngas), rho=_opt("RHO", ngas), hsml=_opt("HSML", ngas),
            pot=_opt("POT", n),
            accel=None if accel is None else accel.reshape(n, 3),
            dtentr=_opt("ENDT", ngas), tstp=_opt("TSTP", n),
        )


def _write_record(f, payload: bytes, name: str | None, format2: bool):
    if format2:
        namebuf = (name or "    ").ljust(4)[:4].encode("latin1") + struct.pack("<i", len(payload) + 8)
        f.write(struct.pack("<i", 8) + namebuf + struct.pack("<i", 8))
    f.write(struct.pack("<i", len(payload)))
    f.write(payload)
    f.write(struct.pack("<i", len(payload)))


def write_snapshot(path: str, data: SnapshotData, snap_format: int = 1,
                   with_pot: bool | None = None, longids: bool = False):
    """Write a snapshot; arrays must already be type-sorted (gas first).

    Mass entries equal to the header MassTable entry are elided into the
    header, matching io.c's block-presence rules (io.c:366-533).  Optional
    blocks (POT/ACCE/ENDT/TSTP) are written whenever the corresponding
    SnapshotData field is set; `with_pot=False` suppresses POT for
    back-compatibility.  `longids` writes 64-bit ID blocks (-DLONGIDS).
    """
    h = data.header
    npart = h.npart.astype(np.int64)
    ngas = int(npart[0])
    fmt2 = snap_format == 2
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        _write_record(f, h.pack(), "HEAD", fmt2)
        _write_record(f, np.ascontiguousarray(data.pos, "<f4").tobytes(), "POS", fmt2)
        _write_record(f, np.ascontiguousarray(data.vel, "<f4").tobytes(), "VEL", fmt2)
        id_dtype = "<u8" if (longids or data.pid.dtype.itemsize == 8) else "<u4"
        _write_record(f, np.ascontiguousarray(
            data.pid.astype(np.uint64) if id_dtype == "<u8" else data.pid,
            id_dtype).tobytes(), "ID", fmt2)
        # variable-mass block
        chunks = []
        off = 0
        for t in range(N_TYPES):
            cnt = int(npart[t])
            if cnt and h.mass[t] == 0:
                chunks.append(np.ascontiguousarray(data.mass[off:off + cnt], "<f4"))
            off += cnt
        if chunks:
            _write_record(f, np.concatenate(chunks).tobytes(), "MASS", fmt2)
        if ngas > 0:
            for nm, arr in (("U", data.u), ("RHO", data.rho), ("HSML", data.hsml)):
                if arr is not None:
                    _write_record(f, np.ascontiguousarray(arr[:ngas], "<f4").tobytes(), nm, fmt2)
        if data.pot is not None and with_pot is not False:
            _write_record(f, np.ascontiguousarray(data.pot, "<f4").tobytes(), "POT", fmt2)
        if data.accel is not None:
            _write_record(f, np.ascontiguousarray(data.accel, "<f4").tobytes(), "ACCE", fmt2)
        if ngas > 0 and data.dtentr is not None:
            _write_record(f, np.ascontiguousarray(data.dtentr[:ngas], "<f4").tobytes(), "ENDT", fmt2)
        if data.tstp is not None:
            _write_record(f, np.ascontiguousarray(data.tstp, "<f4").tobytes(), "TSTP", fmt2)


# ----------------------------------------------------------------------
# Format 3 (HDF5) — the reference's optional HAVE_HDF5 path
# (io.c:998-1120, read_ic.c:~280-600).  Gadget-2 group/dataset names.

_H5_HEADER_ATTRS = [
    ("NumPart_ThisFile", "npart", np.int32),
    ("MassTable", "mass", np.float64),
    ("Time", "time", float),
    ("Redshift", "redshift", float),
    ("Flag_Sfr", "flag_sfr", int),
    ("Flag_Feedback", "flag_feedback", int),
    ("NumPart_Total", "npart_total", np.uint32),
    ("Flag_Cooling", "flag_cooling", int),
    ("NumFilesPerSnapshot", "num_files", int),
    ("BoxSize", "box_size", float),
    ("Omega0", "omega0", float),
    ("OmegaLambda", "omega_lambda", float),
    ("HubbleParam", "hubble_param", float),
]


def write_snapshot_hdf5(path: str, data: SnapshotData,
                        with_pot: bool | None = None, longids: bool = False):
    """Format-3 snapshot (HDF5), Gadget-2 dataset names
    (io.c:613-653,998-1120)."""
    import h5py

    h = data.header
    npart = h.npart.astype(np.int64)
    id_dtype = "<u8" if (longids or data.pid.dtype.itemsize == 8) else "<u4"
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        hdr = f.create_group("Header")
        for aname, fname, typ in _H5_HEADER_ATTRS:
            v = getattr(h, fname)
            hdr.attrs[aname] = np.asarray(v, typ) if isinstance(
                v, np.ndarray) else typ(v)
        off = 0
        for t in range(N_TYPES):
            cnt = int(npart[t])
            if cnt == 0:
                off += cnt
                continue
            grp = f.create_group(f"PartType{t}")
            sl = slice(off, off + cnt)
            grp.create_dataset("Coordinates", data=np.asarray(data.pos[sl], "<f4"))
            grp.create_dataset("Velocities", data=np.asarray(data.vel[sl], "<f4"))
            grp.create_dataset("ParticleIDs", data=np.asarray(
                data.pid[sl].astype(np.uint64) if id_dtype == "<u8"
                else data.pid[sl], id_dtype))
            if h.mass[t] == 0:
                grp.create_dataset("Masses", data=np.asarray(data.mass[sl], "<f4"))
            if t == 0:
                for nm, arr in (("InternalEnergy", data.u),
                                ("Density", data.rho),
                                ("SmoothingLength", data.hsml),
                                ("RateOfChangeOfEntropy", data.dtentr)):
                    if arr is not None:
                        grp.create_dataset(nm, data=np.asarray(arr[:cnt], "<f4"))
            if data.pot is not None and with_pot is not False:
                grp.create_dataset("Potential", data=np.asarray(data.pot[sl], "<f4"))
            if data.accel is not None:
                grp.create_dataset("Acceleration",
                                   data=np.asarray(data.accel[sl], "<f4"))
            if data.tstp is not None:
                grp.create_dataset("TimeStep",
                                   data=np.asarray(data.tstp[sl], "<f4"))
            off += cnt


def read_snapshot_hdf5(path: str) -> SnapshotData:
    import h5py

    with h5py.File(path, "r") as f:
        hdr = f["Header"].attrs
        h = SnapshotHeader()
        for aname, fname, _ in _H5_HEADER_ATTRS:
            if aname in hdr:
                setattr(h, fname, hdr[aname])
        h.npart = np.asarray(h.npart, np.int32)
        h.mass = np.asarray(h.mass, np.float64)
        h.npart_total = np.asarray(h.npart_total, np.uint32)
        npart = h.npart.astype(np.int64)
        n = int(npart.sum())
        ngas = int(npart[0])
        pos = np.empty((n, 3), np.float32)
        vel = np.empty((n, 3), np.float32)
        pid = np.empty(n, np.uint64)
        longids = False
        mass = np.empty(n, np.float32)
        pot = np.empty(n, np.float32)
        accel = np.empty((n, 3), np.float32)
        tstp = np.empty(n, np.float32)
        have_pot = have_accel = have_tstp = True
        u = rho = hsml = dtentr = None
        off = 0
        for t in range(N_TYPES):
            cnt = int(npart[t])
            if cnt == 0:
                continue
            grp = f[f"PartType{t}"]
            sl = slice(off, off + cnt)
            pos[sl] = grp["Coordinates"][...]
            vel[sl] = grp["Velocities"][...]
            ids = grp["ParticleIDs"][...]
            longids = longids or ids.dtype.itemsize == 8
            pid[sl] = ids
            mass[sl] = grp["Masses"][...] if "Masses" in grp else h.mass[t]
            if "Potential" in grp:
                pot[sl] = grp["Potential"][...]
            else:
                have_pot = False
            if "Acceleration" in grp:
                accel[sl] = grp["Acceleration"][...]
            else:
                have_accel = False
            if "TimeStep" in grp:
                tstp[sl] = grp["TimeStep"][...]
            else:
                have_tstp = False
            if t == 0:
                u = grp["InternalEnergy"][...] if "InternalEnergy" in grp else None
                rho = grp["Density"][...] if "Density" in grp else None
                hsml = grp["SmoothingLength"][...] if "SmoothingLength" in grp else None
                dtentr = grp["RateOfChangeOfEntropy"][...] \
                    if "RateOfChangeOfEntropy" in grp else None
            off += cnt
        ptype = np.repeat(np.arange(N_TYPES, dtype=np.int32), npart)
        return SnapshotData(header=h, pos=pos, vel=vel,
                            pid=pid if longids else pid.astype(np.uint32),
                            mass=mass, ptype=ptype, u=u, rho=rho, hsml=hsml,
                            pot=pot if have_pot else None,
                            accel=accel if have_accel else None,
                            dtentr=dtentr, tstp=tstp if have_tstp else None)


# ----------------------------------------------------------------------
# Multi-file snapshots (read_ic.c:615 find_files; io.c:94-112 distribute)

def find_files(base: str) -> list[str]:
    """Snapshot file set discovery (read_ic.c:615-686): `base` itself, or
    `base.0 .. base.(numfiles-1)`, or `base.hdf5` / `base.N.hdf5`."""
    for cand in (base, base + ".hdf5"):
        if os.path.exists(cand):
            return [cand]
    for first in (base + ".0", base + ".0.hdf5"):
        if os.path.exists(first):
            files = [first]
            i = 1
            while True:
                nxt = (f"{base}.{i}.hdf5" if first.endswith(".hdf5")
                       else f"{base}.{i}")
                if not os.path.exists(nxt):
                    break
                files.append(nxt)
                i += 1
            return files
    raise FileNotFoundError(f"no snapshot files found for base {base!r}")


def _read_any(path: str) -> SnapshotData:
    if path.endswith(".hdf5") or path.endswith(".h5"):
        return read_snapshot_hdf5(path)
    return read_snapshot(path)


def read_snapshot_set(base: str) -> SnapshotData:
    """Read a possibly multi-file snapshot, concatenating per type in file
    order (round-robin group reading analog, read_ic.c:54-103)."""
    files = find_files(base)
    parts = [_read_any(p) for p in files]
    if len(parts) == 1:
        return parts[0]
    h = parts[0].header
    npart = np.sum([p.header.npart for p in parts], axis=0).astype(np.int32)
    cat = {}
    for name in ("pos", "vel", "pid", "mass", "ptype", "pot", "accel", "tstp"):
        if name in ("pot", "accel", "tstp") and \
                any(getattr(p, name) is None for p in parts):
            cat[name] = None
            continue
        chunks = []
        for t in range(N_TYPES):
            for p in parts:
                m = p.ptype == t
                if m.any():
                    chunks.append(getattr(p, name)[m])
        cat[name] = np.concatenate(chunks) if chunks else getattr(parts[0], name)
    gas = {}
    for name in ("u", "rho", "hsml", "dtentr"):
        vals = [getattr(p, name) for p in parts if getattr(p, name) is not None]
        gas[name] = np.concatenate(vals) if vals else None
    h.npart = npart
    h.num_files = 1
    return SnapshotData(header=h, ptype=cat["ptype"], pos=cat["pos"],
                        vel=cat["vel"], pid=cat["pid"], mass=cat["mass"],
                        u=gas["u"], rho=gas["rho"], hsml=gas["hsml"],
                        pot=cat["pot"], accel=cat["accel"],
                        dtentr=gas["dtentr"], tstp=cat["tstp"])


def write_snapshot_multi(base: str, data: SnapshotData, num_files: int,
                         snap_format: int = 1, with_pot: bool | None = None,
                         longids: bool = False,
                         max_parallel: int | None = None):
    """Split a snapshot across `num_files` files (`base.0 .. base.N-1`),
    particles of every type divided contiguously — the sharded-write analog
    of io.c:94-112 (files written by independent workers, group-throttled to
    `max_parallel` concurrent writers like NumFilesWrittenInParallel)."""
    import concurrent.futures as cf

    h = data.header
    npart = h.npart.astype(np.int64)
    jobs = []
    for k in range(num_files):
        sel = np.zeros(data.n, bool)
        sub_np = np.zeros(N_TYPES, np.int32)
        off = 0
        for t in range(N_TYPES):
            cnt = int(npart[t])
            lo = off + (cnt * k) // num_files
            hi = off + (cnt * (k + 1)) // num_files
            sel[lo:hi] = True
            sub_np[t] = hi - lo
            off += cnt
        hh = dataclasses.replace(
            h, npart=sub_np, num_files=num_files,
            npart_total=h.npart.astype(np.uint32))
        sub = SnapshotData(
            header=hh, pos=data.pos[sel], vel=data.vel[sel],
            pid=data.pid[sel], mass=data.mass[sel], ptype=data.ptype[sel],
            u=None if data.u is None else data.u[sel[:len(data.u)]],
            rho=None if data.rho is None else data.rho[sel[:len(data.rho)]],
            hsml=None if data.hsml is None else data.hsml[sel[:len(data.hsml)]],
            pot=None if data.pot is None else data.pot[sel],
            accel=None if data.accel is None else data.accel[sel],
            dtentr=None if data.dtentr is None
            else data.dtentr[sel[:len(data.dtentr)]],
            tstp=None if data.tstp is None else data.tstp[sel])
        if snap_format == 3:
            jobs.append((write_snapshot_hdf5, (f"{base}.{k}.hdf5", sub),
                         dict(with_pot=with_pot, longids=longids)))
        else:
            jobs.append((write_snapshot, (f"{base}.{k}", sub),
                         dict(snap_format=snap_format, with_pot=with_pot,
                              longids=longids)))
    workers = max_parallel or num_files
    with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        list(ex.map(lambda j: j[0](*j[1], **j[2]), jobs))
