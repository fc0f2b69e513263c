"""Minimal dependency-free ONNX exporter (the port's own copy of
``tpu2048/utils/onnx_writer.py``; pure numpy, and for the same params tree
it writes the same bytes).

The reference exports its GameMLP to ONNX for the in-browser demo via
torch.onnx (reference train.py:33-78). This image ships no ``onnx`` package,
so this module serializes the ONNX protobuf wire format directly — enough of
ModelProto/GraphProto/NodeProto/TensorProto to express the GameMLP graph
(Gemm / LayerNormalization / Relu / Add), opset 17, weights embedded — the
exact artifact shape (input ``board_state`` (1,48), outputs ``action_logits``
(1,4) and ``value`` (1,1)) the demo site's ONNX Runtime Web session expects.

Protobuf encoding is by hand: varints + length-delimited fields only.
"""

from __future__ import annotations

import struct

import numpy as np

# --- protobuf primitives -----------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _f_string(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode())


# --- ONNX messages -----------------------------------------------------------

FLOAT = 1  # TensorProto.DataType
INT64 = 7
ATTR_FLOAT, ATTR_INT, ATTR_INTS = 1, 2, 7  # AttributeProto.AttributeType


def tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto with raw_data (field 9). float32 or int64."""
    if np.issubdtype(np.asarray(array).dtype, np.integer):
        a = np.ascontiguousarray(array, dtype=np.int64)
        dtype = INT64
    else:
        a = np.ascontiguousarray(array, dtype=np.float32)
        dtype = FLOAT
    msg = b""
    for d in a.shape:
        msg += _f_varint(1, d)  # dims
    msg += _f_varint(2, dtype)  # data_type
    msg += _f_string(8, name)  # name
    msg += _f_bytes(9, a.tobytes())  # raw_data
    return msg


def _attr_int(name: str, value: int) -> bytes:
    return _f_string(1, name) + _key(3, 0) + _varint(value) + _f_varint(20, ATTR_INT)


def _attr_ints(name: str, values) -> bytes:
    msg = _f_string(1, name)
    for v in values:
        msg += _key(8, 0) + _varint(v & ((1 << 64) - 1))
    return msg + _f_varint(20, ATTR_INTS)


def _attr_float(name: str, value: float) -> bytes:
    return (
        _f_string(1, name)
        + _key(2, 5)
        + struct.pack("<f", value)
        + _f_varint(20, ATTR_FLOAT)
    )


def node(op_type: str, inputs: list, outputs: list, name: str = "",
         attrs: list = ()) -> bytes:
    msg = b""
    for i in inputs:
        msg += _f_string(1, i)
    for o in outputs:
        msg += _f_string(2, o)
    msg += _f_string(3, name or f"{op_type}_{outputs[0]}")
    msg += _f_string(4, op_type)
    for a in attrs:
        msg += _f_bytes(5, a)
    return msg


def _value_info(name: str, shape: tuple) -> bytes:
    dims = b""
    for d in shape:
        dims += _f_bytes(1, _f_varint(1, d))  # Dimension.dim_value
    tensor_type = _f_varint(1, FLOAT) + _f_bytes(2, dims)  # elem_type, shape
    type_proto = _f_bytes(1, tensor_type)  # TypeProto.tensor_type
    return _f_string(1, name) + _f_bytes(2, type_proto)


def model(graph_name: str, nodes: list, initializers: list, inputs: list,
          outputs: list, opset: int = 17, producer: str = "tpu2048") -> bytes:
    graph = b""
    for n in nodes:
        graph += _f_bytes(1, n)
    graph += _f_string(2, graph_name)
    for t in initializers:
        graph += _f_bytes(5, t)
    for name, shape in inputs:
        graph += _f_bytes(11, _value_info(name, shape))
    for name, shape in outputs:
        graph += _f_bytes(12, _value_info(name, shape))

    opset_import = _f_varint(2, opset)  # domain defaults to ""
    msg = _f_varint(1, 8)  # ir_version 8
    msg += _f_string(2, producer)
    msg += _f_bytes(7, graph)
    msg += _f_bytes(8, opset_import)
    return msg


# --- GameMLP graph -----------------------------------------------------------


def export_mlp(params: dict, config, output_path) -> None:
    """Serialize a GameMLP params pytree to ONNX (eval mode: dropout dropped).

    Graph: stem Gemm(no bias) -> LayerNormalization -> Relu ->
    [per block: Gemm -> LN -> Relu -> Add(residual)] -> two Gemm heads.
    """
    h = config.hidden_dim
    nodes, inits = [], []

    def gemm(x, w_name, w, b_name=None, b=None, out="y"):
        inits.append(tensor(w_name, np.asarray(w)))
        ins = [x, w_name]
        if b is not None:
            inits.append(tensor(b_name, np.asarray(b)))
            ins.append(b_name)
        nodes.append(node("Gemm", ins, [out], attrs=[_attr_int("transB", 1)]))
        return out

    def layer_norm(x, g_name, g, b_name, b, out):
        inits.append(tensor(g_name, np.asarray(g)))
        inits.append(tensor(b_name, np.asarray(b)))
        nodes.append(
            node("LayerNormalization", [x, g_name, b_name], [out],
                 attrs=[_attr_int("axis", -1), _attr_float("epsilon", 1e-5)])
        )
        return out

    def relu(x, out):
        nodes.append(node("Relu", [x], [out]))
        return out

    x = gemm("board_state", "stem.w", params["stem"]["lin"]["w"], out="stem_mm")
    x = layer_norm(x, "stem.g", params["stem"]["ln"]["g"], "stem.b",
                   params["stem"]["ln"]["b"], "stem_ln")
    x = relu(x, "stem_out")

    for i, block in enumerate(params["blocks"]):
        mm = gemm(x, f"b{i}.w", block["lin"]["w"], out=f"b{i}_mm")
        ln = layer_norm(mm, f"b{i}.g", block["ln"]["g"], f"b{i}.b",
                        block["ln"]["b"], f"b{i}_ln")
        r = relu(ln, f"b{i}_relu")
        nodes.append(node("Add", [x, r], [f"b{i}_out"]))
        x = f"b{i}_out"

    gemm(x, "action.w", params["action_head"]["w"], "action.b",
         params["action_head"]["b"], out="action_logits")
    gemm(x, "value.w", params["value_head"]["w"], "value.b",
         params["value_head"]["b"], out="value")

    blob = model(
        "game_mlp", nodes, inits,
        inputs=[("board_state", (1, 48))],
        outputs=[("action_logits", (1, 4)), ("value", (1, 1))],
    )
    with open(output_path, "wb") as f:
        f.write(blob)


# --- GameURM graph -----------------------------------------------------------


def export_urm(params: dict, config, output_path) -> None:
    """Serialize a GameURM params pytree to ONNX (eval mode).

    The recurrent transformer (models/urm.py; reference game.py:1355-1458,
    whose training path the reference ships disabled) decomposed into opset-17
    primitives: attention as MatMul/Transpose/Softmax, ConvSwiGLU's depthwise
    conv as Pad + k shifted Mul/Add taps, parameter-free RMSNorm as
    Mul/ReduceMean/Sqrt/Div, the ``num_loops`` recurrence unrolled (weights
    shared — one initializer, many references). Same artifact contract as the
    MLP exporter: input ``board_state`` (1,48), outputs ``action_logits`` /
    ``value`` (reference train.py:33-78)."""
    h, inter, k = config.hidden_dim, config.inter, config.conv_kernel
    nh, hd = config.num_heads, config.hidden_dim // config.num_heads
    L = 16
    nodes, inits = [], []
    init_names = set()

    def add_init(name, arr):
        if name not in init_names:
            init_names.add(name)
            inits.append(tensor(name, np.asarray(arr)))
        return name

    def matmul(x, w_name, w, out):
        """x @ w.T via MatMul with the transposed weight as initializer
        (works on 3-D activations, unlike Gemm)."""
        add_init(w_name, np.asarray(w).T)
        nodes.append(node("MatMul", [x, w_name], [out]))
        return out

    def silu(x, out):
        nodes.append(node("Sigmoid", [x], [f"{out}_sig"]))
        nodes.append(node("Mul", [x, f"{out}_sig"], [out]))
        return out

    def rmsnorm(x, out):
        eps = add_init("rms_eps", np.float32(config.rms_norm_eps))
        nodes.append(node("Mul", [x, x], [f"{out}_sq"]))
        nodes.append(node("ReduceMean", [f"{out}_sq"], [f"{out}_ms"],
                          attrs=[_attr_ints("axes", [-1]),
                                 _attr_int("keepdims", 1)]))
        nodes.append(node("Add", [f"{out}_ms", eps], [f"{out}_mse"]))
        nodes.append(node("Sqrt", [f"{out}_mse"], [f"{out}_rms"]))
        nodes.append(node("Div", [x, f"{out}_rms"], [out]))
        return out

    def slice_axis(x, start, end, axis, out):
        add_init(f"i64_{start}", np.array([start], np.int64))
        add_init(f"i64_{end}", np.array([end], np.int64))
        add_init(f"i64_{axis}", np.array([axis], np.int64))
        nodes.append(node("Slice", [x, f"i64_{start}", f"i64_{end}",
                                    f"i64_{axis}"], [out]))
        return out

    def reshape(x, shape, out):
        add_init(f"shape_{'_'.join(map(str, shape))}",
                 np.array(shape, np.int64))
        nodes.append(node("Reshape",
                          [x, f"shape_{'_'.join(map(str, shape))}"], [out]))
        return out

    def transpose(x, perm, out):
        nodes.append(node("Transpose", [x], [out],
                          attrs=[_attr_ints("perm", perm)]))
        return out

    def attention(p, x, w_prefix, tag):
        qkv = matmul(x, f"{w_prefix}.qkv", p["qkv"]["w"], f"{tag}_qkv")
        heads = []
        for i, name in enumerate(("q", "k", "v")):
            s = slice_axis(qkv, i * h, (i + 1) * h, 2, f"{tag}_{name}")
            r = reshape(s, (0, L, nh, hd), f"{tag}_{name}4")
            heads.append(r)
        q = transpose(heads[0], (0, 2, 1, 3), f"{tag}_qT")  # (B,nh,L,hd)
        kt = transpose(heads[1], (0, 2, 3, 1), f"{tag}_kT")  # (B,nh,hd,L)
        v = transpose(heads[2], (0, 2, 1, 3), f"{tag}_vT")
        nodes.append(node("MatMul", [q, kt], [f"{tag}_scores"]))
        scale = add_init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
        nodes.append(node("Mul", [f"{tag}_scores", scale], [f"{tag}_scaled"]))
        nodes.append(node("Softmax", [f"{tag}_scaled"], [f"{tag}_probs"],
                          attrs=[_attr_int("axis", -1)]))
        nodes.append(node("MatMul", [f"{tag}_probs", v], [f"{tag}_ctx"]))
        ct = transpose(f"{tag}_ctx", (0, 2, 1, 3), f"{tag}_ctxT")
        cr = reshape(ct, (0, L, h), f"{tag}_ctx2")
        return matmul(cr, f"{w_prefix}.o", p["o"]["w"], f"{tag}_attn")

    def conv_swiglu(p, x, w_prefix, tag):
        gu = matmul(x, f"{w_prefix}.gate_up", p["gate_up"]["w"], f"{tag}_gu")
        gate = slice_axis(gu, 0, inter, 2, f"{tag}_gate")
        up = slice_axis(gu, inter, 2 * inter, 2, f"{tag}_up")
        sg = silu(gate, f"{tag}_sgate")
        nodes.append(node("Mul", [sg, up], [f"{tag}_h"]))
        # depthwise conv over the cell axis: Pad + k shifted taps
        pad = k // 2
        pads = add_init(f"pads_{pad}", np.array([0, pad, 0, 0, pad, 0], np.int64))
        nodes.append(node("Pad", [f"{tag}_h", pads], [f"{tag}_hp"]))
        acc = None
        for j in range(k):
            tap = slice_axis(f"{tag}_hp", j, j + L, 1, f"{tag}_tap{j}")
            wj = add_init(f"{w_prefix}.dw{j}", p["dwconv"]["w"][:, j])
            nodes.append(node("Mul", [tap, wj], [f"{tag}_m{j}"]))
            if acc is None:
                acc = f"{tag}_m{j}"
            else:
                nodes.append(node("Add", [acc, f"{tag}_m{j}"], [f"{tag}_a{j}"]))
                acc = f"{tag}_a{j}"
        bias = add_init(f"{w_prefix}.dwb", p["dwconv"]["b"])
        nodes.append(node("Add", [acc, bias], [f"{tag}_conv"]))
        sc = silu(f"{tag}_conv", f"{tag}_sconv")
        return matmul(sc, f"{w_prefix}.down", p["down"]["w"], f"{tag}_ff")

    # stem: (B,48) -> (B,16,3) -> Linear -> LN -> SiLU
    xr = reshape("board_state", (0, L, 3), "cells")
    st = matmul(xr, "stem.w", params["stem"]["lin"]["w"], "stem_mm")
    add_init("stem.g", params["stem"]["ln"]["g"])
    add_init("stem.b", params["stem"]["ln"]["b"])
    nodes.append(node("LayerNormalization", ["stem_mm", "stem.g", "stem.b"],
                      ["stem_ln"],
                      attrs=[_attr_int("axis", -1),
                             _attr_float("epsilon", 1e-5)]))
    emb = silu("stem_ln", "emb")

    hidden = add_init("init_hidden", params["init_hidden"])  # (1,16,h), broadcasts
    for loop in range(config.num_loops):
        nodes.append(node("Add", [hidden, emb], [f"l{loop}_in"]))
        x = f"l{loop}_in"
        for bi, block in enumerate(params["blocks"]):
            tag = f"l{loop}b{bi}"
            attn = attention(block, x, f"b{bi}", f"{tag}_att")
            nodes.append(node("Add", [x, attn], [f"{tag}_res1"]))
            x = rmsnorm(f"{tag}_res1", f"{tag}_n1")
            ff = conv_swiglu(block, x, f"b{bi}", f"{tag}_ffn")
            nodes.append(node("Add", [x, ff], [f"{tag}_res2"]))
            x = rmsnorm(f"{tag}_res2", f"{tag}_n2")
        hidden = x

    nodes.append(node("ReduceMean", [hidden], ["pooled"],
                      attrs=[_attr_ints("axes", [1]),
                             _attr_int("keepdims", 0)]))
    for head, out in (("action_head", "action_logits"), ("value_head", "value")):
        add_init(f"{out}.w", params[head]["w"])
        add_init(f"{out}.b", params[head]["b"])
        nodes.append(node("Gemm", ["pooled", f"{out}.w", f"{out}.b"], [out],
                          attrs=[_attr_int("transB", 1)]))

    blob = model(
        "game_urm", nodes, inits,
        inputs=[("board_state", (1, 48))],
        outputs=[("action_logits", (1, 4)), ("value", (1, 1))],
    )
    with open(output_path, "wb") as f:
        f.write(blob)
