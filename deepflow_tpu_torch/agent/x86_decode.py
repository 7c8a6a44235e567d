"""Minimal x86-64 instruction-length decoder: walk code at instruction
granularity and find RET offsets.

Reference role: the agent attaches Go function EXIT probes as uprobes
on every RET instruction of the function body (uretprobes are unsafe
under goroutine stack moves), found by disassembling the function with
bddisasm — `agent/src/ebpf/user/symbol.c:184-232`
(resolve_func_ret_addr: NdDecodeEx loop collecting ND_INS_RETN/RETF).
This module is that capability in-tree: not a full disassembler, just
a length decoder complete enough to walk compiler-generated 64-bit
code (gcc/clang/Go output) so a RET byte inside an immediate or
displacement is never mistaken for an instruction boundary.

Coverage: legacy prefixes, REX, the one-byte map, the 0x0F two-byte
map, and the 0x0F38/0x0F3A three-byte maps (SSE/AVX-adjacent forms the
compilers emit), VEX (0xC4/0xC5). Unknown opcodes raise DecodeError —
a caller walking a function either gets boundaries it can trust or an
explicit failure (attaching a probe mid-instruction corrupts the
traced process; guessing is not an option).

The port's own copy of the JAX package's `agent/x86_decode.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

from typing import List

# one-byte opcodes with a ModRM byte
_MODRM_1B = set()
for _op in range(0x00, 0x40):
    # arithmetic blocks: 00-03, 08-0b, ... (the +4/+5 AL,imm forms and
    # 0x0f escape / segment pushes excluded below)
    if _op & 7 in (0, 1, 2, 3):
        _MODRM_1B.add(_op)
_MODRM_1B |= {0x62, 0x63, 0x69, 0x6B,
              0x80, 0x81, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
              0x88, 0x89, 0x8A, 0x8B, 0x8C, 0x8D, 0x8E, 0x8F,
              0xC0, 0xC1, 0xC4, 0xC5, 0xC6, 0xC7,
              0xD0, 0xD1, 0xD2, 0xD3,
              0xD8, 0xD9, 0xDA, 0xDB, 0xDC, 0xDD, 0xDE, 0xDF,
              0xF6, 0xF7, 0xFE, 0xFF}

# one-byte opcodes: immediate size class
#   1 = imm8, 2 = imm16, 4 = imm32 (imm16 with 0x66), 8 = special
_IMM_1B = {
    0x04: 1, 0x0C: 1, 0x14: 1, 0x1C: 1, 0x24: 1, 0x2C: 1, 0x34: 1,
    0x3C: 1,                                    # <op> AL, imm8
    0x05: 4, 0x0D: 4, 0x15: 4, 0x1D: 4, 0x25: 4, 0x2D: 4, 0x35: 4,
    0x3D: 4,                                    # <op> eAX, imm32
    0x68: 4, 0x69: 4, 0x6A: 1, 0x6B: 1,
    0x80: 1, 0x81: 4, 0x82: 1, 0x83: 1,
    0xA8: 1, 0xA9: 4,
    0xC0: 1, 0xC1: 1, 0xC2: 2, 0xC6: 1, 0xC7: 4,
    0xCD: 1, 0xD4: 1, 0xD5: 1,
    0xE4: 1, 0xE5: 1, 0xE6: 1, 0xE7: 1,
    0xE8: 4, 0xE9: 4,
    0xEB: 1,
}
for _op in range(0x70, 0x80):                   # Jcc rel8
    _IMM_1B[_op] = 1
for _op in range(0xB0, 0xB8):                   # MOV r8, imm8
    _IMM_1B[_op] = 1
# B8-BF: MOV r, imm32 (imm64 with REX.W; imm16 with 0x66) — special
# A0-A3: MOV al/ax/eax/rax, moffs — 8-byte address in 64-bit mode
# E0-E3: LOOPcc/JCXZ rel8
for _op in (0xE0, 0xE1, 0xE2, 0xE3):
    _IMM_1B[_op] = 1

# two-byte (0F xx) opcodes WITHOUT ModRM
_NO_MODRM_2B = (set(range(0x80, 0x90))          # Jcc rel32
                | {0x05, 0x06, 0x07, 0x08, 0x09, 0x0B, 0x0E,
                   0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x37,
                   0x77, 0xA0, 0xA1, 0xA2, 0xA8, 0xA9, 0xAA}
                | set(range(0xC8, 0xD0)))       # BSWAP
# two-byte opcodes with an imm8 after ModRM
_IMM8_2B = {0x70, 0x71, 0x72, 0x73, 0xA4, 0xAC, 0xBA, 0xC2, 0xC4,
            0xC5, 0xC6}

_PREFIXES = {0x26, 0x2E, 0x36, 0x3E, 0x64, 0x65, 0x66, 0x67,
             0xF0, 0xF2, 0xF3}


class DecodeError(ValueError):
    pass


def _modrm_len(code: bytes, i: int, addr32: bool) -> int:
    """Bytes consumed by ModRM + SIB + displacement starting at i."""
    if i >= len(code):
        raise DecodeError("truncated at ModRM")
    modrm = code[i]
    mod, rm = modrm >> 6, modrm & 7
    n = 1
    if mod == 3:
        return n
    if not addr32:          # 64-bit addressing (the normal case)
        if rm == 4:                              # SIB follows
            if i + 1 >= len(code):
                raise DecodeError("truncated at SIB")
            sib = code[i + 1]
            n += 1
            if mod == 0 and (sib & 7) == 5:
                n += 4                           # disp32 base
        if mod == 1:
            n += 1
        elif mod == 2:
            n += 4
        elif mod == 0 and rm == 5:
            n += 4                               # RIP-relative disp32
        return n
    # 0x67 16/32-bit addressing never appears in compiler output we
    # walk; refuse rather than silently mis-measure
    raise DecodeError("0x67 address-size override unsupported")


def insn_len(code: bytes, i: int = 0) -> int:
    """Length of the instruction starting at code[i]."""
    start = i
    osize16 = False
    rex_w = False
    addr32 = False
    # prefixes
    while i < len(code) and code[i] in _PREFIXES:
        if code[i] == 0x66:
            osize16 = True
        if code[i] == 0x67:
            addr32 = True
        i += 1
    if i < len(code) and 0x40 <= code[i] <= 0x4F:   # REX
        rex_w = bool(code[i] & 8)
        i += 1
    if i >= len(code):
        raise DecodeError("truncated in prefixes")
    op = code[i]
    i += 1

    if op in (0xC4, 0xC5):                      # VEX (not the LES/LDS
        # legacy forms — those don't exist in 64-bit mode)
        vex3 = op == 0xC4
        if i + (2 if vex3 else 1) > len(code):
            raise DecodeError("truncated in VEX")
        # the 3-byte form's first payload byte carries the opcode MAP
        # in its low 5 bits (1=0F, 2=0F38, 3=0F3A); the 2-byte form is
        # always map 1. The map decides the imm8: 0F3A instructions
        # ALWAYS carry one — measuring them short would desynchronize
        # the walk silently, the exact guess this module must refuse
        vmap = (code[i] & 0x1F) if vex3 else 1
        i += 2 if vex3 else 1
        if i >= len(code):
            raise DecodeError("truncated after VEX prefix")
        vop = code[i]
        i += 1
        if vmap == 1 and vop in _NO_MODRM_2B:
            return i - start                    # e.g. vzeroupper (77)
        i += _modrm_len(code, i, addr32)
        if vmap == 3:
            i += 1                              # 0F3A map: imm8 always
        elif vmap == 2:
            pass                                # 0F38 map: no imm
        elif vmap == 1:
            if vop in _IMM8_2B or vop in (0x4A, 0x4B, 0x44):
                i += 1
        else:
            raise DecodeError(f"unknown VEX map {vmap}")
        return i - start

    if op == 0x0F:
        if i >= len(code):
            raise DecodeError("truncated after 0F")
        op2 = code[i]
        i += 1
        if op2 in (0x38, 0x3A):                 # three-byte maps
            if i >= len(code):
                raise DecodeError("truncated after 0F38/3A")
            i += 1                              # the third opcode byte
            i += _modrm_len(code, i, addr32)
            if op2 == 0x3A:                     # 0F3A always carries imm8
                i += 1
            return i - start
        if 0x80 <= op2 <= 0x8F:                 # Jcc rel32
            return i - start + 4
        if op2 not in _NO_MODRM_2B:
            i += _modrm_len(code, i, addr32)
        if op2 in _IMM8_2B:
            i += 1
        return i - start

    if 0xD8 <= op <= 0xDF:                      # x87: ModRM only
        i += _modrm_len(code, i, addr32)
        return i - start

    if op in _MODRM_1B:
        i += _modrm_len(code, i, addr32)

    if 0xB8 <= op <= 0xBF:                      # MOV r, imm
        i += 8 if rex_w else (2 if osize16 else 4)
    elif 0xA0 <= op <= 0xA3:                    # MOV moffs (64-bit addr)
        i += 8
    elif op in _IMM_1B:
        n = _IMM_1B[op]
        if n == 4 and osize16:
            n = 2
        # group 3 TEST /0-/1 carries an immediate; F6/F7 handled below
        i += n
    elif op in (0xF6, 0xF7):
        # group 3: TEST (/0,/1) has an immediate, the rest don't —
        # the reg field of the ALREADY-CONSUMED ModRM decides
        modrm_at = start
        # re-find the modrm byte: prefixes + rex + opcode
        j = start
        while code[j] in _PREFIXES:
            j += 1
        if 0x40 <= code[j] <= 0x4F:
            j += 1
        j += 1                                  # the opcode itself
        reg = (code[j] >> 3) & 7
        if reg in (0, 1):
            i += 1 if op == 0xF6 else (2 if osize16 else 4)
    elif op in (0xC8,):                         # ENTER imm16, imm8
        i += 3
    elif op in (0x9A, 0xEA):
        raise DecodeError("far call/jmp invalid in 64-bit mode")

    return i - start


def find_ret_offsets(code: bytes) -> List[int]:
    """Offsets of RET instructions (C3 / C2 iw) at TRUE instruction
    boundaries within `code` (one function's bytes). Mirrors
    symbol.c:resolve_func_ret_addr; raises DecodeError on opcodes the
    walker doesn't know (caller treats the function as unprobeable
    rather than probing a guessed boundary)."""
    out: List[int] = []
    i = 0
    while i < len(code):
        op = code[i]
        # skip prefixes to identify the opcode for the RET test
        j = i
        while j < len(code) and code[j] in _PREFIXES:
            j += 1
        if j < len(code) and 0x40 <= code[j] <= 0x4F:
            j += 1
        if j < len(code) and code[j] in (0xC3, 0xC2):
            out.append(i)
        i += insn_len(code, i)
        del op
    return out
