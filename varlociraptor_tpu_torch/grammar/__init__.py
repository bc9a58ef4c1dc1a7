from .scenario import Scenario  # noqa: F401
from .formula import parse_formula, parse_universe  # noqa: F401
from .compiler import compile_scenario_events  # noqa: F401
