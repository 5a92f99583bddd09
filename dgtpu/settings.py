"""Nested attribute-tree configuration loaded from the YAML paramfile.

Same schema and key mangling as the reference (``dgfem/settings.py``): dict
keys have spaces replaced by underscores and become attributes; dotted-path
updates; CLI-kwarg overlay; cross-field validation asserts
(Poisson => local ordering; Stokes multigrid => global ordering +
multiply_inverse_mass_matrix).

The paramfile is read by a small loader for the subset of YAML it uses
(nested maps by indentation, ``#`` comments, YAML 1.1 scalars), so the
package needs no YAML library.
"""

import os
import re

DEFAULT_PARAMFILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "input", "paramfile.yml")

# YAML 1.1 core-schema scalars, as PyYAML's safe loader resolves them
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")


def parse_scalar(text):
    """One plain or quoted YAML 1.1 scalar -> None/bool/int/float/str."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _OCT.match(text):
        return int(text.replace("_", ""), 8)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    return text


def _strip_comment(line):
    """Drop a ``#`` comment (at line start or after whitespace, outside
    quotes) and trailing whitespace."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_params(text):
    """Parse the paramfile subset of YAML: ``key: value`` lines whose
    indentation nests maps, keys may contain spaces, ``#`` starts a
    comment.  A key with no value opens a nested map when the next line
    is indented deeper, else maps to None."""
    root = {}
    stack = [(-1, root)]          # (indent, map) of every open map
    pending = None                # (indent, parent, key) awaiting children
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        if "\t" in line[:indent + 1]:
            raise ValueError(f"line {lineno}: tabs are not allowed in "
                             "indentation")
        if pending is not None:
            p_indent, parent, key = pending
            pending = None
            if indent > p_indent:
                child = {}
                parent[key] = child
                stack.append((p_indent, child))
        while indent <= stack[-1][0]:
            stack.pop()
        key, sep, value = line.strip().partition(":")
        if not sep or (value and not value.startswith((" ", "\t"))):
            raise ValueError(f"line {lineno}: expected 'key: value', "
                             f"got {raw!r}")
        key, value = key.strip(), value.strip()
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        mapping[key] = parse_scalar(value)
        if not value:
            pending = (indent, mapping, key)
    return root


def load_params(path=None):
    with open(path or DEFAULT_PARAMFILE) as f:
        return parse_params(f.read())


class Settings:
    def __init__(self, params):
        self._load_settings(params)

    def _load_settings(self, params):
        for key, value in params.items():
            if isinstance(value, dict):
                setattr(self, key.replace(" ", "_"), Settings(value))
            else:
                setattr(self, key.replace(" ", "_"), value)

    def _attribute_exists(self, attribute_path):
        obj = self
        for key in attribute_path.split("."):
            if not hasattr(obj, key):
                return False
            obj = getattr(obj, key)
        return True

    def _validate_settings(self, settings):
        if settings.solver.method == "smoother_amplification":
            assert settings.problem.type == "Poisson"
            if settings.solver.discretization == "dg":
                assert settings.solution.u.polynomial_degree == 6
            elif settings.solver.discretization == "fvm":
                assert settings.solution.u.polynomial_degree == 0
        if settings.problem.type == "Poisson":
            assert settings.solution.ordering == "local"
        if settings.problem.type == "Stokes":
            if settings.solver.method == "multigrid":
                assert settings.solution.ordering == "global"
                assert settings.problem.multiply_inverse_mass_matrix is True

    def update_setting(self, attribute_path, new_value):
        """Dotted-path setter.  Parent nodes must exist; the leaf may be new
        (e.g. ``solver.discretization`` / ``solver.method`` are injected by the
        CLI overlay, as in the reference where the existence check is a no-op)."""
        parent = attribute_path.rsplit(".", 1)[0] if "." in attribute_path else None
        if parent and not self._attribute_exists(parent):
            raise AttributeError(f'Attribute "{attribute_path}" does not exist!')
        keys = attribute_path.split(".")
        obj = self
        for key in keys[:-1]:
            obj = getattr(obj, key)
        setattr(obj, keys[-1], new_value)

    def update_settings(self, kwargs):
        """Overlay CLI keyword arguments onto the settings tree (settings.py:46-73)."""
        mapping = {
            "grid_folder": "grid.folder",
            "grid_file": "grid.filename",
            "p_grid": "grid.polynomial_degree",
            "p_solution": "solution.u.polynomial_degree",
            "manufactured_solution": "solution.manufactured_solution",
            "solution_polynomial_degree_u": "solution.u.polynomial_degree",
            "solution_polynomial_degree_p": "solution.p.polynomial_degree",
            "solution_ordering": "solution.ordering",
            "problem_kinematic_viscosity": "problem.kinematic_viscosity",
            "SIP_penalty_parameter": "problem.SIP_penalty_parameter",
            "SIP_penalty_parameter_multiplier": "problem.SIP_penalty_parameter_multiplier",
            "velocity_penalty_parameter": "problem.velocity_penalty_parameter",
            "exact_solution_u": "problem.exact_solution.u",
            "exact_solution_v": "problem.exact_solution.v",
            "exact_solution_p": "problem.exact_solution.p",
            "exact_solution_tag": "problem.exact_solution.tag",
            "smoother": "solver.smoother",
            "shards": "performance.n_shards",
            "precision": "performance.precision",
        }
        for kw, path in mapping.items():
            if kwargs.get(kw) is not None and kwargs.get(kw) is not False:
                self.update_setting(path, kwargs[kw])
        for flag in ("check_eigenvalues", "check_condition_number"):
            if kwargs.get(flag):
                self.update_setting(f"problem.{flag}", True)
        if kwargs.get("plot_sparsity_pattern"):
            self.update_setting("visualization.plot_sparsity_pattern", True)
        if kwargs.get("discretization"):
            self.update_setting("solver.discretization", kwargs["discretization"])
        else:
            self.update_setting("solver.discretization", "dg")
        if kwargs.get("solve_finite_volume_method"):
            self.update_setting("solver.discretization", "fvm")

    def to_dict(self):
        out = {}
        for key, value in self.__dict__.items():
            if isinstance(value, Settings):
                out[key] = value.to_dict()
            elif callable(value):
                out[key] = str(value)
            else:
                out[key] = value
        return out
