"""Tools subsystem: safe calculator, gated code execution, registry, selector.

Capability parity with reference `agents/tools.py:24-468`: `BaseTool` ABC +
`ToolResult`; `CalculatorTool` as a whitelisted-AST evaluator (NO eval of
arbitrary code); sandboxed `CodeExecutionTool` (disabled unless explicitly
allowed); `ToolRegistry`; LLM-driven `ToolSelector`; and
`create_default_tool_registry()`. The orchestrator executes planned tools and
injects outputs into synthesis context (`orchestrator.py:785-817,1399-1407`).

The port's copy of `radiant_rag_tpu/agents/tools.py`, unchanged.
"""

from __future__ import annotations

import abc
import ast
import logging
import math
import operator
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class ToolResult:
    tool: str
    success: bool
    output: Any = None
    error: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"tool": self.tool, "success": self.success,
                "output": self.output, "error": self.error}


class BaseTool(abc.ABC):
    name: str = "tool"
    description: str = ""

    @abc.abstractmethod
    def run(self, input: str) -> ToolResult:
        ...


_BIN_OPS: Dict[type, Callable] = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
}
_UNARY_OPS: Dict[type, Callable] = {ast.USub: operator.neg, ast.UAdd: operator.pos}
_FUNCTIONS: Dict[str, Callable] = {
    "abs": abs, "round": round, "min": min, "max": max, "sum": sum,
    "sqrt": math.sqrt, "log": math.log, "log10": math.log10, "log2": math.log2,
    "exp": math.exp, "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "floor": math.floor, "ceil": math.ceil, "pow": pow,
}
_CONSTANTS: Dict[str, float] = {"pi": math.pi, "e": math.e, "tau": math.tau}


class CalculatorTool(BaseTool):
    """Arithmetic evaluator by AST walk over a whitelist — never eval()
    (reference `agents/tools.py:87-230`)."""

    name = "calculator"
    description = "Evaluate arithmetic expressions, e.g. '2*(3+4)' or 'sqrt(2)'."
    MAX_POW = 1000

    def run(self, input: str) -> ToolResult:
        try:
            tree = ast.parse(input.strip(), mode="eval")
            value = self._eval(tree.body)
            return ToolResult(tool=self.name, success=True, output=value)
        except Exception as exc:
            return ToolResult(tool=self.name, success=False,
                              error=f"{type(exc).__name__}: {exc}")

    def _eval(self, node: ast.AST) -> Any:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)):
                return node.value
            raise ValueError(f"non-numeric constant: {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id in _CONSTANTS:
                return _CONSTANTS[node.id]
            raise ValueError(f"unknown name: {node.id}")
        if isinstance(node, ast.BinOp):
            op = _BIN_OPS.get(type(node.op))
            if op is None:
                raise ValueError(f"operator not allowed: {type(node.op).__name__}")
            left, right = self._eval(node.left), self._eval(node.right)
            if isinstance(node.op, ast.Pow) and abs(right) > self.MAX_POW:
                raise ValueError("exponent too large")
            return op(left, right)
        if isinstance(node, ast.UnaryOp):
            op = _UNARY_OPS.get(type(node.op))
            if op is None:
                raise ValueError(f"unary operator not allowed: {type(node.op).__name__}")
            return op(self._eval(node.operand))
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name) or node.func.id not in _FUNCTIONS:
                raise ValueError("function not allowed")
            if node.keywords:
                raise ValueError("keyword arguments not allowed")
            args = [self._eval(a) for a in node.args]
            return _FUNCTIONS[node.func.id](*args)
        if isinstance(node, (ast.Tuple, ast.List)):
            return [self._eval(e) for e in node.elts]
        if isinstance(node, ast.Compare):
            raise ValueError("comparisons not allowed")
        raise ValueError(f"syntax not allowed: {type(node).__name__}")


class CodeExecutionTool(BaseTool):
    """Restricted python exec — disabled by default; enable only in trusted
    deployments (reference gates similarly)."""

    name = "code_execution"
    description = "Execute a short python snippet and return its `result` variable."

    def __init__(self, allowed: bool = False, timeout_s: float = 5.0) -> None:
        self.allowed = allowed
        self.timeout_s = timeout_s

    def run(self, input: str) -> ToolResult:
        if not self.allowed:
            return ToolResult(tool=self.name, success=False,
                              error="code execution is disabled by configuration")
        safe_builtins = {"abs": abs, "min": min, "max": max, "sum": sum,
                         "len": len, "range": range, "round": round,
                         "sorted": sorted, "enumerate": enumerate, "zip": zip}
        scope: Dict[str, Any] = {"__builtins__": safe_builtins, "math": math}
        try:
            exec(compile(input, "<tool>", "exec"), scope)  # noqa: S102 - gated
            return ToolResult(tool=self.name, success=True,
                              output=scope.get("result"))
        except Exception as exc:
            return ToolResult(tool=self.name, success=False,
                              error=f"{type(exc).__name__}: {exc}")


class ToolRegistry:
    def __init__(self) -> None:
        self._tools: Dict[str, BaseTool] = {}

    def register(self, tool: BaseTool) -> None:
        self._tools[tool.name] = tool

    def get(self, name: str) -> Optional[BaseTool]:
        return self._tools.get(name)

    def run(self, name: str, input: str) -> ToolResult:
        tool = self.get(name)
        if tool is None:
            return ToolResult(tool=name, success=False, error="unknown tool")
        return tool.run(input)

    def list_tools(self) -> List[Dict[str, str]]:
        return [{"name": t.name, "description": t.description}
                for t in self._tools.values()]

    def __contains__(self, name: str) -> bool:
        return name in self._tools


class ToolSelector:
    """LLM picks tools + inputs for a query (reference ToolSelector)."""

    def __init__(self, llm, registry: ToolRegistry) -> None:
        self.llm = llm
        self.registry = registry

    def select(self, query: str) -> List[Dict[str, str]]:
        tools = self.registry.list_tools()
        if not tools:
            return []
        listing = "\n".join(f"- {t['name']}: {t['description']}" for t in tools)
        arr = self.llm.chat_json([{
            "role": "user",
            "content": (
                "Which tools (if any) would help answer this query? Return a JSON "
                'array of {"tool": name, "input": string}; empty array if none.\n\n'
                f"Tools:\n{listing}\n\nQuery: {query}"
            ),
        }], expect=list)
        out = []
        for item in arr or []:
            if isinstance(item, dict) and item.get("tool") in self.registry:
                out.append({"tool": str(item["tool"]), "input": str(item.get("input", ""))})
        return out


def create_default_tool_registry(allow_code_execution: bool = False) -> ToolRegistry:
    reg = ToolRegistry()
    reg.register(CalculatorTool())
    reg.register(CodeExecutionTool(allowed=allow_code_execution))
    return reg
