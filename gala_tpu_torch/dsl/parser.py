"""Text-DSL frontend: parses GALA `.txt` programs into a ModelSpec.

Clean-room Python replacement for the reference's flex/bison frontend
(reference: src/frontend/frontend.l tokens, frontend.y grammar).  The
grammar recognizes layer bodies by *pattern-matching statements* to
LayerOps rather than interpreting them (reference: frontend.y:84-280);
this parser reproduces that statement-level classification, so the
reference's entire DSL corpus (tests/GALA-DSL/**.txt) parses unchanged.

Statement classification (matching the bison actions):

    deg = G.graphs.degrees();              -> GET_DEGREES
    x = dsl.fn.pow(a, p);                  -> GET_NORMALIZATION (captures p)
    x = a * b;                             -> MULT_NORM_RES
    x = a + b;                             -> ADD_SCALAR_AGGR
    x = f(a, b);                           -> MESSAGE_PASSING_AGGREGATE
    x = f(a, b, c);                        -> ATTN
    x = f(a);                              -> NON_LINEARITY
    x = dsl.nn.ffn(a, out=ident);          -> FEED_FORWARD_NN
    x = dsl.nn.ffn(a, out=INT);            -> ATTEN_L (skipped if prev ATTEN_L)
    x = dsl.nn.ffn(..) + dsl.nn.ffn(..);   -> SAGE_OPS (expanded)
    x = dsl.nn.scalar(INT) * y;            -> MULT_SCALAR_FEATS
    G.edges.vals = dsl.fn.softmax(G, a);   -> SOFTMAX
    G.node.feats = f(res);                 -> NON_LINEARITY
"""
from __future__ import annotations

import re

from gala_tpu_torch.dsl.spec import (
    ComputeSchedule,
    GraphSchedule,
    LayerOp,
    ModelSpec,
    PassFlags,
)


class DSLSyntaxError(ValueError):
    pass


def _strip_comments(src: str) -> str:
    src = re.sub(r"//[^\n]*", "", src)
    src = re.sub(r"#[^\n]*", "", src)  # '#.*' is a comment in the lexer too
    return src


def _split_statements(src: str) -> list[str]:
    """Split on ';' at brace depth 0; blocks `name = kind(args) { body }`
    are kept whole."""
    stmts, buf, depth = [], [], 0
    i = 0
    while i < len(src):
        ch = src[i]
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            buf.append(ch)
            if depth == 0 and "".join(buf).strip():
                stmts.append("".join(buf).strip())
                buf = []
            i += 1
            continue
        if ch == ";" and depth == 0:
            s = "".join(buf).strip()
            if s:
                stmts.append(s)
            buf = []
        else:
            buf.append(ch)
        i += 1
    if "".join(buf).strip():
        stmts.append("".join(buf).strip())
    return stmts


_CALL_RE = re.compile(r"^(?P<callee>[\w.$]+)\s*\((?P<args>.*)\)$", re.S)


def _split_args(argstr: str) -> list[str]:
    args, buf, depth = [], [], 0
    for ch in argstr:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    last = "".join(buf).strip()
    if last:
        args.append(last)
    return args


def _classify_layer_stmt(lhs: str, rhs: str, ops: list[LayerOp], spec: ModelSpec):
    """Map one layer-body statement to LayerOp(s), mirroring the bison
    `statement`/`gnn_op`/`function`/`update_op` actions."""
    rhs = rhs.strip()

    # SAGE: ffn(...) + ffn(...)  (reference: `ffn_aggr op ffn_aggr` -> SAGE_OPS)
    if rhs.count("nn.ffn") == 2 and "+" in rhs:
        # reference inserts degrees+norm at the *front* and appends
        # MULT_NORM_RES + ADD_TWO_FFN (frontend.y SAGE_OPS case)
        ops.insert(0, LayerOp.GET_NORMALIZATION)
        ops.insert(0, LayerOp.GET_DEGREES)
        ops.append(LayerOp.MULT_NORM_RES)
        ops.append(LayerOp.ADD_TWO_FFN)
        return

    # degrees: `deg = G.graphs.degrees()`
    if re.search(r"\.graphs\s*\.\s*degrees\s*\(\s*\)$", rhs):
        ops.append(LayerOp.GET_DEGREES)
        return

    m = _CALL_RE.match(rhs)
    if m:
        callee = m.group("callee")
        args = _split_args(m.group("args"))
        if callee.endswith("fn.pow"):
            if len(args) >= 2:
                try:
                    spec.normalization_value = float(args[1])
                except ValueError:
                    pass
            ops.append(LayerOp.GET_NORMALIZATION)
            return
        if callee.endswith("fn.softmax"):
            ops.append(LayerOp.SOFTMAX)
            return
        if callee.endswith("nn.init_weight"):
            ops.append(LayerOp.ATTEN_L)
            return
        if callee.endswith("fn.leaky_relu"):
            ops.append(LayerOp.LEAKY_RELU)
            return
        if callee.endswith("nn.ffn"):
            out_arg = next((a for a in args if a.startswith("out")), "")
            out_val = out_arg.split("=", 1)[1].strip() if "=" in out_arg else ""
            if re.fullmatch(r"-?\d+", out_val):
                # ffn(x, out=INT): attention head; reference pushes ATTEN_L
                # only when the previous op isn't already ATTEN_L
                if not ops or ops[-1] is not LayerOp.ATTEN_L:
                    ops.append(LayerOp.ATTEN_L)
                return
            ops.append(LayerOp.FEED_FORWARD_NN)
            return
        # plain calls: arity decides (reference: `function` rule)
        if len(args) == 3:
            ops.append(LayerOp.ATTN)
            return
        if len(args) == 2:
            ops.append(LayerOp.MESSAGE_PASSING_AGGREGATE)
            return
        if len(args) == 1:
            ops.append(LayerOp.NON_LINEARITY)
            return

    # binary infix ops
    if re.search(r"nn\.scalar\s*\(\s*-?\d+\s*\)\s*\*", rhs):
        ops.append(LayerOp.MULT_SCALAR_FEATS)
        return
    if "*" in rhs:
        ops.append(LayerOp.MULT_NORM_RES)
        return
    if "+" in rhs:
        ops.append(LayerOp.ADD_SCALAR_AGGR)
        return
    raise DSLSyntaxError(f"unrecognized layer statement: {lhs} = {rhs}")


def _balanced_call(s: str) -> bool:
    """True when parens close properly and the statement ends on ')'."""
    depth = 0
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                return False
    return depth == 0 and s.rstrip().endswith(")")


def parse_source(source: str) -> ModelSpec:
    spec = ModelSpec()
    src = _strip_comments(source)
    block_names: set[str] = set()  # layer/model names, for init statements

    for stmt in _split_statements(src):
        # ---- block definitions -------------------------------------- #
        blk = re.match(
            r"^(?P<name>\w+)\s*=\s*(?P<kind>layer|model)\s*\((?P<args>[^)]*)\)\s*"
            r"\{(?P<body>.*)\}$",
            stmt, re.S,
        )
        if blk:
            block_names.add(blk.group("name"))
            body = blk.group("body")
            if blk.group("kind") == "layer":
                for s in _split_statements(body):
                    if "=" not in s:
                        continue
                    lhs, rhs = s.split("=", 1)
                    _classify_layer_stmt(lhs.strip(), rhs.strip(), spec.layer_ops, spec)
            else:  # model: layer_init list
                for s in _split_statements(body):
                    m = re.match(r"^\w+\s*=\s*\w+\s*\((?P<args>.*)\)$", s.strip(), re.S)
                    if not m:
                        continue
                    args = _split_args(m.group("args"))
                    spec.num_layers += 1
                    # arg[1] = output size (INT or G.labels.size())
                    size = args[1].strip() if len(args) > 1 else ""
                    if re.fullmatch(r"-?\d+", size):
                        spec.output_sizes.append(int(size))
                    else:
                        spec.output_sizes.append(0)  # labels.size() placeholder
                    # arg[2] = nonln fn or null (reference: `!$5` on the
                    # null-ness of the nonln arg)
                    nonln = args[2].strip() if len(args) > 2 else "null"
                    spec.nonln_present.append(nonln != "null")
            continue

        # ---- simple statements -------------------------------------- #
        s = stmt.replace(" ", "")
        m = re.match(r'^\w+=load_dataset\("(?P<d>[^"]*)"\)$', s)
        if m:
            spec.dataset = m.group("d")
            continue
        m = re.match(r"^\w+\.train\((?P<args>.*)\)$", s)
        if m:
            for a in _split_args(m.group("args")):
                k, _, v = a.partition("=")
                if k == "iters":
                    spec.iterations = int(v)
                elif k == "validation_step":
                    spec.valid_step = int(v)
            continue
        # schedule directives
        m = re.match(r"^\w+=\w+\.set_undirected\((true|false)\)$", s)
        if m:
            spec.graph.undirected = m.group(1) == "true"
            continue
        m = re.match(r"^\w+=\w+\.set_unweighted\((true|false)\)$", s)
        if m:
            spec.graph.unweighted = m.group(1) == "true"
            continue
        m = re.match(r"^\w+=\w+\.is_sparser\((true|false)\)$", s)
        if m:
            spec.graph.sparser = m.group(1) == "true"
            continue
        m = re.match(r"^attention_heads\((\d+)\)$", s)
        if m:
            spec.attention_heads = int(m.group(1))
            continue
        m = re.match(r"^feature_size\((-?\d+)\)$", s)
        if m:
            spec.graph.feat_size = int(m.group(1))
            continue
        m = re.match(r"^label_size\((-?\d+)\)$", s)
        if m:
            spec.graph.label_size = int(m.group(1))
            continue
        m = re.match(r"^\w+=\w+\.col_tile\((-?\d+)\)$", s)
        if m:
            spec.col_tile = float(m.group(1))
            continue
        m = re.match(r"^aggrFn=aggrFn\.coarsen\((-?\d+)\)$", s)
        if m:
            spec.compute.coarsen = int(m.group(1))
            continue
        m = re.match(r"^aggrFn=aggrFn\.sample\((-?\d+)\)\.dynamic\(\)$", s)
        if m:
            spec.compute.sample_dynamic = int(m.group(1))
            continue
        m = re.match(r"^aggrFn=aggrFn\.sample\((-?\d+)\)$", s)
        if m:
            spec.compute.sample = int(m.group(1))
            continue
        m = re.match(r"^\w+=\w+\.sample\((-?\d+)\)$", s)
        if m:
            spec.graph.sample = int(m.group(1))
            continue
        m = re.match(r'^\w+=\w+\.opt_input\("(?P<p>[^"]*)"\)$', s)
        if m:
            spec.opt_input = m.group("p")
            continue
        m = re.match(r"^print_accuracy\((true|false)\)$", s)
        if m:
            spec.print_accuracy = m.group(1) == "true"
            continue
        m = re.match(r"^print_memory\((true|false)\)$", s)
        if m:
            spec.print_memory = m.group(1) == "true"
            continue
        m = re.match(
            r"^(operator_reordering|sparse_rewrites|training_subgraph|"
            r"train_code_motion)\((true|false)\)$", s,
        )
        if m:
            setattr(spec.passes, m.group(1), m.group(2) == "true")
            continue
        # ignored statements: aggr/edge fn init (mean detection below),
        # model init, eval
        if "get_aggregate" in s:
            if "mul_mean" in s:
                # mean aggregation: deg^-1 normalization (SAGE); the
                # normalization value stays -1 (ModelConfig default)
                spec.normalization_value = -1.0
            continue
        if "get_edge_aggregate" in s or ".eval(" in s:
            continue
        # model init: `m1 = M1(G, dsl.non_ln.ReLU)` — the callee must be a
        # block defined above (reference: bison resolves the ident against
        # the model table), and the call must close its parens; anything
        # else here is a malformed or unknown statement, not a no-op.
        m = re.match(r"^\w+=(?P<callee>\w+)\(", s)
        if m and m.group("callee") in block_names and _balanced_call(s):
            continue
        if "load_dataset" in s:
            raise DSLSyntaxError(f"malformed load_dataset statement: {stmt!r}")
        if m and m.group("callee") in block_names:
            raise DSLSyntaxError(f"unbalanced model init statement: {stmt!r}")
        raise DSLSyntaxError(f"unrecognized statement: {stmt!r}")

    if spec.output_sizes and spec.output_sizes[-1] == 0:
        # last layer used G.labels.size()
        spec.output_sizes[-1] = spec.graph.label_size
    return spec


def parse_file(path: str) -> ModelSpec:
    with open(path) as f:
        return parse_source(f.read())
