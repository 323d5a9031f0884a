"""Single-flit packet codec — paper §4.3 (Fig. 5) and §5.1 (Fig. 6).

Flits are 43 bits: an 11-bit header and a 32-bit payload.

Header layout (most-significant first), exactly as §4.3:

    [ mesh-X : 3 ][ mesh-Y : 3 ][ ringlet : 2 ][ pe : 2 ][ vc : 1 ]

which supports a global mesh of up to 8x8 routers, 4 ringlets per block and
4 PEs per ringlet -> 8*8*4*4 = 1024 PEs.

Morph (configuration) packets — §5.1, Fig. 6 — ride in the 32-bit payload:

    [ HL : 1 ][ ERS : 10 ][ LC : 16 ][ PTS : 5 ]

and are announced in-band by an escape flit whose payload is 0xFFFFFFFF.
A data payload that happens to be 0xFFFFFFFF is escaped by sending it twice.
The LSB of PTS is forced to zero so a morph payload can never alias the
escape word; PTS == 0x00 selects the extended RFT control packets (§5.1.1).

Everything here is plain integer arithmetic (numpy-compatible) so the same
codec is used by the python control plane, the tests and the PyTorch simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

# ---------------------------------------------------------------------------
# Field widths (paper Fig. 5)
# ---------------------------------------------------------------------------
MESH_X_BITS = 3
MESH_Y_BITS = 3
RINGLET_BITS = 2
PE_BITS = 2
VC_BITS = 1
HEADER_BITS = MESH_X_BITS + MESH_Y_BITS + RINGLET_BITS + PE_BITS + VC_BITS
PAYLOAD_BITS = 32
FLIT_BITS = HEADER_BITS + PAYLOAD_BITS  # 43, per the paper

assert HEADER_BITS == 11

RINGLETS_PER_BLOCK = 4
PES_PER_RINGLET = 4
PES_PER_BLOCK = RINGLETS_PER_BLOCK * PES_PER_RINGLET  # 16
MAX_MESH_X = 1 << MESH_X_BITS  # 8
MAX_MESH_Y = 1 << MESH_Y_BITS  # 8
MAX_PES = MAX_MESH_X * MAX_MESH_Y * PES_PER_BLOCK  # 1024

ESCAPE_PAYLOAD = 0xFFFFFFFF

# Morph payload field widths (paper Fig. 6)
HL_BITS = 1
ERS_BITS = 10
LC_BITS = 16
PTS_BITS = 5
assert HL_BITS + ERS_BITS + LC_BITS + PTS_BITS == PAYLOAD_BITS

# Link states encoded by each 2-bit LC group (paper §5.1)
LINK_ACTIVE = 0b00
LINK_BYPASS = 0b01
LINK_OFF = 0b10


@dataclasses.dataclass(frozen=True)
class PEAddress:
    """Hierarchical PE address: global-mesh block coords + ringlet + pe."""

    mesh_x: int
    mesh_y: int
    ringlet: int
    pe: int

    def flat(self, blocks_x: int) -> int:
        """Flat PE id under row-major block numbering."""
        block = self.mesh_y * blocks_x + self.mesh_x
        return (block * RINGLETS_PER_BLOCK + self.ringlet) * PES_PER_RINGLET + self.pe


def pe_address(flat_id: int, blocks_x: int) -> PEAddress:
    pe = flat_id % PES_PER_RINGLET
    ringlet = (flat_id // PES_PER_RINGLET) % RINGLETS_PER_BLOCK
    block = flat_id // PES_PER_BLOCK
    return PEAddress(
        mesh_x=block % blocks_x,
        mesh_y=block // blocks_x,
        ringlet=ringlet,
        pe=pe,
    )


# ---------------------------------------------------------------------------
# Header codec
# ---------------------------------------------------------------------------
def encode_header(addr: PEAddress, vc: int = 0) -> int:
    if not (0 <= addr.mesh_x < MAX_MESH_X and 0 <= addr.mesh_y < MAX_MESH_Y):
        raise ValueError(f"mesh coordinates out of range: {addr}")
    if not (0 <= addr.ringlet < RINGLETS_PER_BLOCK and 0 <= addr.pe < PES_PER_RINGLET):
        raise ValueError(f"ringlet/pe out of range: {addr}")
    if vc not in (0, 1):
        raise ValueError(f"vc must be 0/1, got {vc}")
    h = addr.mesh_x
    h = (h << MESH_Y_BITS) | addr.mesh_y
    h = (h << RINGLET_BITS) | addr.ringlet
    h = (h << PE_BITS) | addr.pe
    h = (h << VC_BITS) | vc
    return h


def decode_header(header: int) -> tuple[PEAddress, int]:
    vc = header & ((1 << VC_BITS) - 1)
    header >>= VC_BITS
    pe = header & ((1 << PE_BITS) - 1)
    header >>= PE_BITS
    ringlet = header & ((1 << RINGLET_BITS) - 1)
    header >>= RINGLET_BITS
    mesh_y = header & ((1 << MESH_Y_BITS) - 1)
    header >>= MESH_Y_BITS
    mesh_x = header & ((1 << MESH_X_BITS) - 1)
    return PEAddress(mesh_x, mesh_y, ringlet, pe), vc


def encode_flit(addr: PEAddress, payload: int, vc: int = 0) -> int:
    if not (0 <= payload < (1 << PAYLOAD_BITS)):
        raise ValueError("payload must fit in 32 bits")
    return (encode_header(addr, vc) << PAYLOAD_BITS) | payload


def decode_flit(flit: int) -> tuple[PEAddress, int, int]:
    payload = flit & ((1 << PAYLOAD_BITS) - 1)
    addr, vc = decode_header(flit >> PAYLOAD_BITS)
    return addr, vc, payload


def vc_for_destination(pe: int) -> int:
    """Ringlet VC policy (§4.2): dst PEs 00/01 -> VC-0, 10/11 -> VC-1."""
    return 0 if pe in (0, 1) else 1


# ---------------------------------------------------------------------------
# Morph packet codec (paper Fig. 6)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MorphPacket:
    """Configuration packet carried in a 32-bit payload.

    hl: 0 -> applies to a ring switch, 1 -> applies to a mesh router.
    ers: execution-region size (number of PEs requested), 10 bits.
    link_states: 8 x 2-bit link states (mesh router: N,S,E,W + 4 ringlets;
        ring switch: only the first 4 groups are meaningful).
    pts: PE-type selector, 5 bits; LSB forced to 0; 0x00 reserved for RFT.
    """

    hl: int
    ers: int
    link_states: tuple[int, ...]
    pts: int = 0b00010

    def __post_init__(self):
        if self.hl not in (0, 1):
            raise ValueError("hl must be 0/1")
        if not 0 <= self.ers < (1 << ERS_BITS):
            raise ValueError("ers out of range")
        if len(self.link_states) != 8:
            raise ValueError("link_states must have 8 entries (2 bits each)")
        if any(s not in (LINK_ACTIVE, LINK_BYPASS, LINK_OFF) for s in self.link_states):
            raise ValueError("invalid link state")
        if not 0 <= self.pts < (1 << PTS_BITS):
            raise ValueError("pts out of range")
        if self.pts & 1:
            raise ValueError("PTS LSB must be 0 (escape-aliasing guard, §5.1)")

    def encode(self) -> int:
        lc = 0
        for state in self.link_states:
            lc = (lc << 2) | state
        word = self.hl
        word = (word << ERS_BITS) | self.ers
        word = (word << LC_BITS) | lc
        word = (word << PTS_BITS) | self.pts
        assert word != ESCAPE_PAYLOAD, "PTS LSB guard makes this unreachable"
        return word


def decode_morph(payload: int) -> MorphPacket:
    pts = payload & ((1 << PTS_BITS) - 1)
    payload >>= PTS_BITS
    lc = payload & ((1 << LC_BITS) - 1)
    payload >>= LC_BITS
    ers = payload & ((1 << ERS_BITS) - 1)
    payload >>= ERS_BITS
    hl = payload & 1
    states = tuple((lc >> (2 * (7 - i))) & 0b11 for i in range(8))
    return MorphPacket(hl=hl, ers=ers, link_states=states, pts=pts)


# ---------------------------------------------------------------------------
# In-band escape protocol (§5.1): a control sequence is ESCAPE then morph
# payload; a literal 0xFFFFFFFF data word is sent as ESCAPE, ESCAPE.
# ---------------------------------------------------------------------------
def escape_stream(payloads: Iterable[tuple[str, int]]) -> list[int]:
    """Encode a stream of ("data"|"morph", word) into raw payload words."""
    out: list[int] = []
    for kind, word in payloads:
        if kind == "data":
            if word == ESCAPE_PAYLOAD:
                out.extend([ESCAPE_PAYLOAD, ESCAPE_PAYLOAD])
            else:
                out.append(word)
        elif kind == "morph":
            out.extend([ESCAPE_PAYLOAD, word])
        else:
            raise ValueError(f"unknown kind {kind}")
    return out


def unescape_stream(words: Iterable[int]) -> list[tuple[str, int]]:
    """Decode raw payload words back into ("data"|"morph", word) events.

    Implements the receiving FSM in the router's routing logic (§5.1): state
    NORMAL consumes data words; seeing ESCAPE enters ESCAPED where a second
    ESCAPE yields the literal data word and anything else is a morph word.
    """
    out: list[tuple[str, int]] = []
    escaped = False
    for w in words:
        if escaped:
            if w == ESCAPE_PAYLOAD:
                out.append(("data", ESCAPE_PAYLOAD))
            else:
                out.append(("morph", w))
            escaped = False
        elif w == ESCAPE_PAYLOAD:
            escaped = True
        else:
            out.append(("data", w))
    if escaped:
        raise ValueError("truncated escape sequence")
    return out


def bitreverse(x: np.ndarray | int, bits: int):
    """Bit-reversal permutation used by the bit-reversal traffic pattern."""
    x = np.asarray(x)
    out = np.zeros_like(x)
    for i in range(bits):
        out = out | (((x >> i) & 1) << (bits - 1 - i))
    return out


def transpose_perm(x: np.ndarray | int, bits: int):
    """Transpose pattern (Dally & Towles): rotate the address by bits//2."""
    x = np.asarray(x)
    half = bits // 2
    mask = (1 << bits) - 1
    return ((x << half) | (x >> (bits - half))) & mask
