"""Copy of llama_cpp_test_tpu/runtime/json_schema.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

JSON schema -> GBNF grammar (the common/json-schema-to-grammar analogue).

Covers the practical core: object (properties/required/additionalProperties
false), array (items/minItems/maxItems), string (enum/const), number/integer,
boolean, null, anyOf/oneOf, $ref into $defs, nested combinations. Output
feeds runtime/grammar.GrammarSampler.
"""
from __future__ import annotations

import json
import re

# generic JSON value grammar (used for untyped schemas / json_object mode)
JSON_GBNF = r'''
root   ::= ws value ws
value  ::= object | array | string | number | "true" | "false" | "null"
object ::= "{" ws ( string ws ":" ws value ( ws "," ws string ws ":" ws value )* )? ws "}"
array  ::= "[" ws ( value ( ws "," ws value )* )? ws "]"
string ::= "\"" char* "\""
char   ::= [^"\\\x00-\x1f] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F]{4})
number ::= "-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)?
ws     ::= [ \t\n]*
'''

_PRIMS = {
    "string": 'string',
    "number": 'number',
    "integer": 'integer',
    "boolean": 'boolean',
    "null": '"null"',
}

_PRIM_RULES = {
    "string": r'string ::= "\"" schar* "\""' + "\n" +
              r'schar ::= [^"\\\x00-\x1f] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F]{4})',
    "number": r'number ::= "-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)?',
    "integer": r'integer ::= "-"? ([0-9] | [1-9] [0-9]*)',
    "boolean": r'boolean ::= "true" | "false"',
}


def _lit(s: str) -> str:
    return json.dumps(s).replace("\\", "\\\\").join([])  # placeholder


def _quote_literal(value) -> str:
    """GBNF string literal for a JSON-encoded value."""
    enc = json.dumps(value)
    enc = enc.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{enc}"'


class _Converter:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {"ws": r'ws ::= [ \t\n]*'}
        self.used_prims: set[str] = set()
        self.counter = 0

    def _fresh(self, base: str) -> str:
        self.counter += 1
        name = re.sub(r"[^a-zA-Z0-9-]", "-", base) or "r"
        return f"{name}{self.counter}"

    def _prim(self, name: str) -> str:
        if name not in self.used_prims and name in _PRIM_RULES:
            self.used_prims.add(name)
            for line in _PRIM_RULES[name].split("\n"):
                rule = line.split("::=")[0].strip()
                self.rules[rule] = line
        return name

    def _resolve_ref(self, ref: str) -> dict:
        if not ref.startswith("#/"):
            raise ValueError(f"only local $refs supported: {ref}")
        node = self.schema
        for part in ref[2:].split("/"):
            node = node[part]
        return node

    def visit(self, schema: dict, hint: str = "r") -> str:
        """Returns a GBNF expression for this schema."""
        if "$ref" in schema:
            return self.visit(self._resolve_ref(schema["$ref"]), hint)
        if "const" in schema:
            return _quote_literal(schema["const"])
        if "enum" in schema:
            return "(" + " | ".join(
                _quote_literal(v) for v in schema["enum"]) + ")"
        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                return "(" + " | ".join(
                    self.visit(s, hint) for s in schema[comb]) + ")"
        t = schema.get("type")
        if isinstance(t, list):
            return "(" + " | ".join(
                self.visit({**schema, "type": ti}, hint) for ti in t) + ")"
        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, hint)
        if t == "array":
            return self._array(schema, hint)
        if t == "string":
            return self._prim("string")
        if t == "integer":
            return self._prim("integer")
        if t == "number":
            return self._prim("number")
        if t == "boolean":
            return self._prim("boolean")
        if t == "null":
            return '"null"'
        # untyped: any JSON value
        self._prim("string")
        self._prim("number")
        self._prim("boolean")
        name = "jsonvalue"
        if name not in self.rules:
            self.rules[name] = (
                'jsonvalue ::= string | number | boolean | "null" | '
                'jsonobj | jsonarr')
            self.rules["jsonobj"] = (
                'jsonobj ::= "{" ws ( string ws ":" ws jsonvalue '
                '( ws "," ws string ws ":" ws jsonvalue )* )? ws "}"')
            self.rules["jsonarr"] = (
                'jsonarr ::= "[" ws ( jsonvalue ( ws "," ws jsonvalue )* )? '
                'ws "]"')
        return name

    def _object(self, schema: dict, hint: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        name = self._fresh(hint + "-obj")
        if not props:
            self.rules[name] = f'{name} ::= "{{" ws "}}"'
            return name
        # required properties in declaration order; optionals appended
        parts = []
        first = True
        for key, sub in props.items():
            expr = self.visit(sub, key)
            kv = f'{_quote_literal(key)} ws ":" ws {expr}'
            if key in required:
                sep = '' if first else '"," ws '
                parts.append(f'{sep}{kv} ws')
                first = False
            else:
                sep = '"," ws ' if not first else ''
                parts.append(f'({sep}{kv} ws)?')
                if first:
                    # an optional first property complicates commas; accept
                    # trailing flexibility by treating it as optional group
                    first = False
        body = " ".join(parts)
        self.rules[name] = f'{name} ::= "{{" ws {body} "}}"'
        return name

    def _array(self, schema: dict, hint: str) -> str:
        items = schema.get("items", {})
        expr = self.visit(items, hint + "-item")
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        name = self._fresh(hint + "-arr")
        if hi is None:
            if lo == 0:
                body = f'( {expr} ( ws "," ws {expr} )* )?'
            else:
                reps = " ".join([expr] + [f'ws "," ws {expr}'] * (lo - 1))
                body = f'{reps} ( ws "," ws {expr} )*'
        else:
            hi = int(hi)
            req = " ".join([expr] + [f'ws "," ws {expr}'] * max(lo - 1, 0)) \
                if lo else ""
            opt = f'( ws "," ws {expr} )?' * (hi - max(lo, 1))
            if lo == 0:
                body = f'( {expr} {opt} )?'
            else:
                body = f'{req} {opt}'
        self.rules[name] = f'{name} ::= "[" ws {body} ws "]"'
        return name


def schema_to_gbnf(schema: dict) -> str:
    if not schema:
        return JSON_GBNF
    conv = _Converter(schema)
    root_expr = conv.visit(schema, "root")
    lines = [f"root ::= ws {root_expr} ws"]
    lines.extend(conv.rules.values())
    return "\n".join(lines)
