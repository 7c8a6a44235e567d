"""Sample wasm L7 plugin: memcached text protocol, hand-assembled.

The same protocol logic as native_src/memcached_plugin.cc (the .so
sample), expressed as a WebAssembly module through wasm_asm — which is
how a plugin author without a wasm toolchain
would still ship one, and how the tests get a real module that
exercises loops, calls, globals, data segments and both host-ABI
directions. Protocol id 202 (the .so sample uses 201) so both can be
loaded side by side.

Memory map: ctx blob @0 (51B), name @64, payload copy @1024 (4KB cap),
record build area @8192, keyword table @12288
([len u8][kind u8][flags u8][bytes]; len==0 terminates; flags bit0 =
response indicates an error status).

The port's own copy of the JAX package's `agent/wasm_samples.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

from deepflow_tpu_torch.agent.wasm_asm import (
    DROP, ELSE, END, I32, I32_ADD, I32_AND, I32_EQ, I32_EQZ, I32_GE_U,
    I32_GT_U, I32_LT_U, I32_NE, I32_OR, I32_SUB, RETURN, ModuleBuilder, block,
    br, br_if, call, global_get, global_set, i32_const, i32_load, i32_load8_u,
    i32_store, i32_store8, i32_store16, if_else, local_get, local_set,
    local_tee, loop)

PROTO_ID = 202
NAME = b"Memcached-wasm"
CTX, NAME_OFF, PAYLOAD, REC, TABLE = 0, 64, 1024, 8192, 12288
PAYLOAD_CAP = 4096

_REQUESTS = [b"get", b"gets", b"set", b"add", b"replace", b"append",
             b"prepend", b"cas", b"delete", b"incr", b"decr", b"touch",
             b"stats", b"flush_all", b"version", b"quit"]
_RESPONSES = [(b"VALUE", 0), (b"END", 0), (b"STORED", 0),
              (b"NOT_STORED", 1), (b"EXISTS", 0), (b"NOT_FOUND", 1),
              (b"DELETED", 0), (b"TOUCHED", 0), (b"OK", 0), (b"ERROR", 1),
              (b"CLIENT_ERROR", 1), (b"SERVER_ERROR", 1), (b"STAT", 0),
              (b"VERSION", 0)]


def _keyword_table() -> bytes:
    out = bytearray()
    for w in _REQUESTS:
        out += bytes([len(w), 0, 0]) + w
    for w, err in _RESPONSES:
        out += bytes([len(w), 1, err]) + w
    out.append(0)
    return bytes(out)


def build_memcached_wasm() -> bytes:
    m = ModuleBuilder()
    t_v_i = m.functype([], [I32])
    t_ii_i = m.functype([I32, I32], [I32])
    t_iii_i = m.functype([I32, I32, I32], [I32])
    t_i_i = m.functype([I32], [I32])
    t_iii_v = m.functype([I32, I32, I32], [])

    fn_read_ctx = m.import_func("df_host", "read_ctx", t_ii_i)
    fn_read_payload = m.import_func("df_host", "read_payload", t_iii_i)
    fn_write_record = m.import_func("df_host", "write_record", t_i_i)
    m.import_func("df_host", "log", t_iii_v)

    m.memory(1, 1)
    g_n = m.global_i32(0)        # copied payload length
    g_tok = m.global_i32(0)      # first-token length
    g_flags = m.global_i32(0)    # matched keyword's flags byte

    # stage() -> i32: pull ctx+payload into guest memory, measure the
    # first token. 0 on host refusal.
    stage = m.func(t_v_i, locals_=[I32, I32], body=(
        i32_const(CTX) + i32_const(64) + call(fn_read_ctx)
        + i32_const(51) + I32_NE
        + if_else(i32_const(0) + RETURN)
        + i32_const(PAYLOAD) + i32_const(0) + i32_const(PAYLOAD_CAP)
        + call(fn_read_payload) + global_set(g_n)
        + i32_const(0) + local_set(0)
        + block(loop(
            local_get(0) + global_get(g_n) + I32_GE_U + br_if(1)
            + local_get(0) + i32_load8_u(PAYLOAD) + local_tee(1)
            + i32_const(32) + I32_EQ
            + local_get(1) + i32_const(13) + I32_EQ + I32_OR
            + local_get(1) + i32_const(10) + I32_EQ + I32_OR
            + br_if(1)
            + local_get(0) + i32_const(1) + I32_ADD + local_set(0)
            + br(0)))
        + local_get(0) + global_set(g_tok)
        + i32_const(1)))

    # tokeq(ptr, len) -> i32: table bytes at ptr == payload[0:len]
    tokeq = m.func(t_ii_i, locals_=[I32], body=(
        i32_const(0) + local_set(2)
        + block(loop(
            local_get(2) + local_get(1) + I32_GE_U
            + if_else(i32_const(1) + RETURN)
            + local_get(0) + local_get(2) + I32_ADD + i32_load8_u(0)
            + local_get(2) + i32_load8_u(PAYLOAD)
            + I32_NE + br_if(1)
            + local_get(2) + i32_const(1) + I32_ADD + local_set(2)
            + br(0)))
        + i32_const(0)))

    # classify() -> i32: kind of the first token (0 req, 1 resp, -1
    # unknown); sets g_flags on match.
    classify = m.func(t_v_i, locals_=[I32, I32], body=(
        i32_const(TABLE) + local_set(0)
        + loop(
            local_get(0) + i32_load8_u(0) + local_tee(1) + I32_EQZ
            + if_else(i32_const(-1) + RETURN)
            + local_get(1) + global_get(g_tok) + I32_EQ
            + if_else(
                local_get(0) + i32_const(3) + I32_ADD + local_get(1)
                + call(tokeq)
                + if_else(
                    local_get(0) + i32_load8_u(2) + global_set(g_flags)
                    + local_get(0) + i32_load8_u(1) + RETURN))
            + local_get(0) + i32_const(3) + I32_ADD + local_get(1)
            + I32_ADD + local_set(0)
            + br(0))
        + i32_const(-1)))

    m.func(t_v_i, body=i32_const(PROTO_ID), export="df_proto")

    m.func(t_ii_i, locals_=[I32], body=(
        local_get(1) + i32_const(len(NAME)) + I32_GT_U
        + if_else(i32_const(len(NAME)) + local_set(1))
        + i32_const(0) + local_set(2)
        + block(loop(
            local_get(2) + local_get(1) + I32_GE_U + br_if(1)
            + local_get(0) + local_get(2) + I32_ADD
            + local_get(2) + i32_load8_u(NAME_OFF)
            + i32_store8(0)
            + local_get(2) + i32_const(1) + I32_ADD + local_set(2)
            + br(0)))
        + i32_const(len(NAME))), export="df_name")

    m.func(t_v_i, locals_=[I32], body=(
        call(stage) + I32_EQZ + if_else(i32_const(0) + RETURN)
        + i32_const(0) + i32_load8_u(37) + i32_const(6) + I32_NE
        + if_else(i32_const(0) + RETURN)
        + global_get(g_n) + i32_const(3) + I32_LT_U
        + if_else(i32_const(0) + RETURN)
        # a text line must terminate inside the slice
        + i32_const(0) + local_set(0)
        + block(loop(
            local_get(0) + global_get(g_n) + I32_GE_U
            + if_else(i32_const(0) + RETURN)
            + local_get(0) + i32_load8_u(PAYLOAD) + i32_const(10) + I32_EQ
            + br_if(1)
            + local_get(0) + i32_const(1) + I32_ADD + local_set(0)
            + br(0)))
        + call(classify) + i32_const(-1) + I32_NE), export="df_check")

    # df_parse: locals i(0) j(1) cmd(2) kind(3) eplen(4) c(5) klen(6)
    m.func(t_v_i, locals_=[I32] * 7, body=(
        call(stage) + I32_EQZ + if_else(i32_const(0) + RETURN)
        + call(classify) + local_tee(3)
        + i32_const(-1) + I32_EQ + if_else(i32_const(0) + RETURN)
        # msg_type
        + i32_const(REC) + local_get(3) + i32_store8(0)
        # status: flags bit0 (nonzero only on error responses)
        + i32_const(0) + global_get(g_flags) + i32_const(1) + I32_AND
        + i32_store(REC + 1)
        # req_len/resp_len from ctx.payload_size
        + local_get(3) + I32_EQZ
        + if_else(
            i32_const(0) + i32_const(0) + i32_load(47)
            + i32_store(REC + 5)
            + i32_const(0) + i32_const(0) + i32_store(REC + 9),
            i32_const(0) + i32_const(0) + i32_store(REC + 5)
            + i32_const(0) + i32_const(0) + i32_load(47)
            + i32_store(REC + 9))
        # endpoint: first token, capped at 120
        + global_get(g_tok) + local_tee(2)
        + i32_const(120) + I32_GT_U
        + if_else(i32_const(120) + local_set(2))
        + i32_const(0) + local_set(0)
        + block(loop(
            local_get(0) + local_get(2) + I32_GE_U + br_if(1)
            + local_get(0)
            + local_get(0) + i32_load8_u(PAYLOAD)
            + i32_store8(REC + 15)
            + local_get(0) + i32_const(1) + I32_ADD + local_set(0)
            + br(0)))
        + local_get(2) + local_set(4)
        # requests append " <key>" (second token)
        + local_get(3) + I32_EQZ
        + if_else(
            global_get(g_tok) + local_set(0)
            + block(loop(
                local_get(0) + global_get(g_n) + I32_GE_U + br_if(1)
                + local_get(0) + i32_load8_u(PAYLOAD)
                + i32_const(32) + I32_NE + br_if(1)
                + local_get(0) + i32_const(1) + I32_ADD + local_set(0)
                + br(0)))
            + local_get(0) + local_set(1)
            + block(loop(
                local_get(1) + global_get(g_n) + I32_GE_U + br_if(1)
                + local_get(1) + i32_load8_u(PAYLOAD) + local_tee(5)
                + i32_const(32) + I32_EQ + br_if(1)
                + local_get(5) + i32_const(13) + I32_EQ + br_if(1)
                + local_get(5) + i32_const(10) + I32_EQ + br_if(1)
                + local_get(1) + i32_const(1) + I32_ADD + local_set(1)
                + br(0)))
            + local_get(1) + local_get(0) + I32_GT_U
            + if_else(
                local_get(2) + i32_const(32) + i32_store8(REC + 15)
                + local_get(1) + local_get(0) + I32_SUB + local_set(6)
                + local_get(6)
                + i32_const(126) + local_get(2) + I32_SUB + I32_GT_U
                + if_else(
                    i32_const(126) + local_get(2) + I32_SUB
                    + local_set(6))
                + i32_const(0) + local_set(5)
                + block(loop(
                    local_get(5) + local_get(6) + I32_GE_U + br_if(1)
                    + local_get(2) + i32_const(1) + I32_ADD
                    + local_get(5) + I32_ADD
                    + local_get(0) + local_get(5) + I32_ADD
                    + i32_load8_u(PAYLOAD)
                    + i32_store8(REC + 15)
                    + local_get(5) + i32_const(1) + I32_ADD
                    + local_set(5)
                    + br(0)))
                + local_get(2) + i32_const(1) + I32_ADD + local_get(6)
                + I32_ADD + local_set(4)))
        + i32_const(0) + local_get(4) + i32_store16(REC + 13)
        + i32_const(REC) + call(fn_write_record) + DROP
        + i32_const(2)), export="df_parse")

    m.data(NAME_OFF, NAME)
    m.data(TABLE, _keyword_table())
    return m.build()
