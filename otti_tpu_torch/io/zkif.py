# copied from otti_tpu/io/zkif.py
"""zkinterface (.zkif) reader/writer — the reference's L2 on-disk boundary.

The reference pipeline exchanges R1CS + inputs + witness between the
compiler and Spartan as three zkinterface FlatBuffers files per instance
(<name>.zkif / .inp.zkif / .wit.zkif, SURVEY.md §1 L2, run.py:45-58).
This module reproduces that boundary so instances/witnesses can be
exchanged with reference-toolchain artifacts: size-prefixed FlatBuffers
messages (Root { message: union { CircuitHeader=1, ConstraintSystem=2,
Witness=3 } }) with the standard zkinterface table layouts.

Wire format implemented directly (little-endian vtables) to avoid a
schema compiler; round-trip tested.  Variable ids: 0 = constant one,
1..n_inputs = instance variables, then witness variables — mapped to and
from our z layout (spartan/r1cs.py).
"""

from __future__ import annotations

import struct

from ..field.fields import SCALAR

FIELD_BYTES = 32
MSG_CIRCUIT_HEADER = 1
MSG_CONSTRAINT_SYSTEM = 2
MSG_WITNESS = 3


# ---------------------------------------------------------------------------
# Minimal FlatBuffers building (little-endian, 4-byte alignment)
# ---------------------------------------------------------------------------

class _FBBuilder:
    """Tiny FlatBuffers writer (built back-to-front, as the format expects).

    Positions are measured *from the end* of the buffer; `finish` pads the
    front so that end-relative alignment equals final absolute alignment.
    """

    def __init__(self):
        self.buf = bytearray()
        self.max_align = 4

    def _tell(self) -> int:
        return len(self.buf)

    def _prepend(self, data: bytes):
        self.buf[:0] = data

    def _align(self, n: int):
        self.max_align = max(self.max_align, n)
        while len(self.buf) % n:
            self._prepend(b"\x00")

    def vector_u64(self, values) -> int:
        data = b"".join(struct.pack("<Q", v) for v in values)
        self._align(8)  # data (len multiple of 8) lands 8-aligned
        self._prepend(data)
        self._prepend(struct.pack("<I", len(values)))
        return self._tell()

    def vector_bytes(self, data: bytes) -> int:
        data = bytes(data)
        self.max_align = max(self.max_align, 4)
        while (self._tell() + len(data)) % 4:  # length prefix 4-aligned
            self._prepend(b"\x00")
        self._prepend(data)
        self._prepend(struct.pack("<I", len(data)))
        return self._tell()

    def vector_offsets(self, targets) -> int:
        """Vector of uoffsets to previously written tables (positions from
        end).  Element i lives at vec_start + 4 + 4*i (absolute address)."""
        n = len(targets)
        self._align(4)
        block = bytearray(4 * n)
        base = self._tell() + 4 * n  # position-from-end of element 0... no:
        # after prepending block+len, element i position-from-end:
        #   p_i = tell_after - 4 - 4*i  where tell_after = tell + 4n + 4
        tell_after = self._tell() + 4 * n + 4
        for i, tgt in enumerate(targets):
            p_i = tell_after - 4 - 4 * i
            struct.pack_into("<I", block, 4 * i, p_i - tgt)
        self._prepend(bytes(block))
        self._prepend(struct.pack("<I", n))
        assert self._tell() == tell_after
        return self._tell()

    def table(self, scalar_slots: dict, offset_slots: dict, byte_slots=None) -> int:
        """scalar_slots: slot -> (struct fmt, value); offset_slots: slot ->
        target position-from-end; byte_slots: slot -> u8 value."""
        byte_slots = byte_slots or {}
        slots = sorted(set(scalar_slots) | set(offset_slots) | set(byte_slots))
        n_slots = (max(slots) + 1) if slots else 0

        field_pos = {}
        for slot in slots:  # ascending slot -> later slots end up earlier
            if slot in scalar_slots:
                fmt, val = scalar_slots[slot]
                self._align(struct.calcsize(fmt))
                self._prepend(struct.pack(fmt, val))
            elif slot in byte_slots:
                self._prepend(struct.pack("<B", byte_slots[slot]))
            else:
                self._align(4)
                self._prepend(b"\x00\x00\x00\x00")  # patched below
            field_pos[slot] = self._tell()

        self._align(4)
        self._prepend(b"\x00\x00\x00\x00")  # soffset placeholder
        table_pos = self._tell()

        for slot, target in offset_slots.items():
            pos = field_pos[slot]
            struct.pack_into("<I", self.buf, len(self.buf) - pos, pos - target)

        vt_len = 4 + 2 * n_slots
        tbl_size = 4 + (table_pos - min(field_pos.values())) if slots else 4
        vt = struct.pack("<HH", vt_len, tbl_size)
        for slot in range(n_slots):
            vt += struct.pack(
                "<H", (table_pos - field_pos[slot]) if slot in field_pos else 0
            )
        self._align(2)
        self._prepend(vt)
        vt_pos = self._tell()
        struct.pack_into(
            "<i", self.buf, len(self.buf) - table_pos, vt_pos - table_pos
        )
        return table_pos

    def finish(self, root_pos: int) -> bytes:
        # pad so the final total length is a multiple of max_align, keeping
        # end-relative alignment == absolute alignment
        total = self._tell() + 4
        pad = (-total) % self.max_align
        self._prepend(bytes(pad))
        self._prepend(struct.pack("<I", self._tell() + 4 - root_pos))
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# Minimal FlatBuffers reading
# ---------------------------------------------------------------------------

class _FBTable:
    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    def _field_pos(self, slot: int):
        soff = struct.unpack_from("<i", self.buf, self.pos)[0]
        vt = self.pos - soff
        vt_len = struct.unpack_from("<H", self.buf, vt)[0]
        fo_pos = vt + 4 + 2 * slot
        if 4 + 2 * slot >= vt_len:
            return None
        fo = struct.unpack_from("<H", self.buf, fo_pos)[0]
        return self.pos + fo if fo else None

    def u64(self, slot: int, default=0):
        p = self._field_pos(slot)
        return struct.unpack_from("<Q", self.buf, p)[0] if p else default

    def u8(self, slot: int, default=0):
        p = self._field_pos(slot)
        return struct.unpack_from("<B", self.buf, p)[0] if p else default

    def table(self, slot: int):
        p = self._field_pos(slot)
        if p is None:
            return None
        rel = struct.unpack_from("<I", self.buf, p)[0]
        return _FBTable(self.buf, p + rel)

    def _vec(self, slot: int):
        p = self._field_pos(slot)
        if p is None:
            return None, 0
        rel = struct.unpack_from("<I", self.buf, p)[0]
        vp = p + rel
        n = struct.unpack_from("<I", self.buf, vp)[0]
        return vp + 4, n

    def vec_u64(self, slot: int):
        start, n = self._vec(slot)
        if start is None:
            return []
        return list(struct.unpack_from(f"<{n}Q", self.buf, start))

    def vec_bytes(self, slot: int) -> bytes:
        start, n = self._vec(slot)
        return self.buf[start : start + n] if start is not None else b""

    def vec_tables(self, slot: int):
        start, n = self._vec(slot)
        out = []
        for i in range(n):
            p = start + 4 * i
            rel = struct.unpack_from("<I", self.buf, p)[0]
            out.append(_FBTable(self.buf, p + rel))
        return out


# ---------------------------------------------------------------------------
# zkinterface messages
# ---------------------------------------------------------------------------

def _encode_scalar(v: int) -> bytes:
    return (v % SCALAR.modulus).to_bytes(FIELD_BYTES, "little")


def _variables(builder: _FBBuilder, ids, values) -> int:
    vals = b"".join(_encode_scalar(v) for v in values)
    off_vals = builder.vector_bytes(vals) if values else None
    off_ids = builder.vector_u64(ids)
    offs = {0: off_ids}
    if off_vals:
        offs[1] = off_vals
    return builder.table({}, offs)


def _root(builder: _FBBuilder, msg_type: int, msg_pos: int) -> bytes:
    root = builder.table({}, {1: msg_pos}, byte_slots={0: msg_type})
    body = builder.finish(root)
    return struct.pack("<I", len(body)) + body


def write_circuit_header(n_inputs: int, input_values, free_var_id: int) -> bytes:
    b = _FBBuilder()
    vars_pos = _variables(b, list(range(1, n_inputs + 1)), list(input_values))
    fm = b.vector_bytes(_encode_scalar(SCALAR.modulus - 1))
    hdr = b.table({1: ("<Q", free_var_id)}, {0: vars_pos, 2: fm})
    return _root(b, MSG_CIRCUIT_HEADER, hdr)


def write_constraint_system(constraints) -> bytes:
    """constraints: list of (a, b, c) where each is list of (var_id, value)."""
    b = _FBBuilder()
    cons_pos = []
    for a, bb, c in constraints:
        lcs = []
        for lc in (a, bb, c):
            ids = [t[0] for t in lc]
            vals = [t[1] for t in lc]
            lcs.append(_variables(b, ids, vals))
        cons_pos.append(b.table({}, {0: lcs[0], 1: lcs[1], 2: lcs[2]}))
    vec = b.vector_offsets(cons_pos)
    cs = b.table({}, {0: vec})
    return _root(b, MSG_CONSTRAINT_SYSTEM, cs)


def write_witness(ids, values) -> bytes:
    b = _FBBuilder()
    vars_pos = _variables(b, list(ids), list(values))
    wit = b.table({}, {0: vars_pos})
    return _root(b, MSG_WITNESS, wit)


def read_messages(data: bytes):
    """Yield (msg_type, _FBTable of the message) from a .zkif byte stream."""
    pos = 0
    while pos + 4 <= len(data):
        size = struct.unpack_from("<I", data, pos)[0]
        body = data[pos + 4 : pos + 4 + size]
        rel = struct.unpack_from("<I", body, 0)[0]
        root = _FBTable(body, rel)
        msg_type = root.u8(0)
        msg = root.table(1)
        yield msg_type, msg
        pos += 4 + size


def parse_variables(tbl: _FBTable):
    ids = tbl.vec_u64(0)
    raw = tbl.vec_bytes(1)
    vals = []
    if raw and ids:
        sz = len(raw) // len(ids)
        vals = [
            int.from_bytes(raw[i * sz : (i + 1) * sz], "little")
            for i in range(len(ids))
        ]
    return ids, vals


# ---------------------------------------------------------------------------
# R1CSShape bridge
# ---------------------------------------------------------------------------

def export_r1cs(shape, vars_ints, inputs_ints, basepath: str):
    """Write <base>.zkif / .inp.zkif / .wit.zkif (reference triple)."""
    nv, ni = shape.num_vars, shape.num_inputs
    npad = shape.num_vars_padded

    def col_to_id(c: int) -> int:
        if c < nv:
            return 1 + ni + c  # witness ids after instance ids
        if c == npad:
            return 0  # constant one
        return c - npad  # instance id (1..ni)

    def mat_rows(mat):
        rows = {}
        for r, c, v in mat:
            rows.setdefault(r, []).append((col_to_id(c), v))
        return rows

    ra, rb, rc = mat_rows(shape.A), mat_rows(shape.B), mat_rows(shape.C)
    constraints = [
        (ra.get(i, []), rb.get(i, []), rc.get(i, []))
        for i in range(shape.num_cons)
    ]
    free_id = 1 + ni + nv
    with open(basepath + ".zkif", "wb") as f:
        f.write(write_circuit_header(ni, inputs_ints, free_id))
        f.write(write_constraint_system(constraints))
    with open(basepath + ".inp.zkif", "wb") as f:
        f.write(write_circuit_header(ni, inputs_ints, free_id))
    with open(basepath + ".wit.zkif", "wb") as f:
        f.write(
            write_witness(range(1 + ni, 1 + ni + nv), vars_ints)
        )


def import_r1cs(
    zkif_path: str, wit_path: str | None = None, inp_path: str | None = None
):
    """-> (R1CSShape, vars_ints, inputs_ints) from zkinterface files.

    Accepts the reference triple (run.py:58 ``spzk verify --nizk a.zkif
    a.inp.zkif a.wit.zkif``): when ``inp_path`` is given its
    CircuitHeader's input assignment overrides the circuit file's (the
    reference emits the public inputs in the separate .inp.zkif)."""
    from ..spartan.r1cs import R1CSShape

    with open(zkif_path, "rb") as f:
        data = f.read()
    n_inputs, input_vals, free_id = 0, [], 1
    constraints = []
    messages = list(read_messages(data))
    if inp_path:
        with open(inp_path, "rb") as f:
            messages += [
                (t, m)
                for t, m in read_messages(f.read())
                if t == MSG_CIRCUIT_HEADER
            ]
    for msg_type, msg in messages:
        if msg_type == MSG_CIRCUIT_HEADER:
            iv = msg.table(0)
            ids, vals = parse_variables(iv) if iv else ([], [])
            n_inputs = len(ids)
            input_vals = vals
            free_id = msg.u64(1)
        elif msg_type == MSG_CONSTRAINT_SYSTEM:
            for con in msg.vec_tables(0):
                lcs = []
                for slot in range(3):
                    t = con.table(slot)
                    lcs.append(parse_variables(t) if t else ([], []))
                constraints.append(lcs)
    n_vars = int(free_id) - 1 - n_inputs

    wit_vals = [0] * n_vars
    if wit_path:
        with open(wit_path, "rb") as f:
            wdata = f.read()
        for msg_type, msg in read_messages(wdata):
            if msg_type == MSG_WITNESS:
                ids, vals = parse_variables(msg.table(0))
                for i, v in zip(ids, vals):
                    if i >= 1 + n_inputs:
                        wit_vals[i - 1 - n_inputs] = v

    def id_to_col(vid: int, nv: int) -> int:
        if vid == 0:
            return nv  # constant one (logical)
        if vid <= n_inputs:
            return nv + vid  # input
        return vid - 1 - n_inputs  # witness

    A, B, C = [], [], []
    for row, (la, lb, lc) in enumerate(constraints):
        for (ids, vals), dst in zip((la, lb, lc), (A, B, C)):
            for vid, v in zip(ids, vals):
                dst.append((row, id_to_col(vid, n_vars), v))
    shape = R1CSShape.from_logical(
        len(constraints), n_vars, n_inputs, A, B, C
    )
    return shape, wit_vals, input_vals
