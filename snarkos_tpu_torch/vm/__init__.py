"""Aleo-instructions program layer: typed values, parser, interpreter.

Covers the reference's program deploy/execute/finalize capability
(snarkVM's VM as reached from snarkOS — SURVEY.md §2.10 "Transaction
create" / ledger speculation rows) with this framework's own interpreter:
deployments parse+validate sources, executions run typed instruction
lists, and finalize blocks apply atomic mapping transitions on commit.
"""

from snarkos_tpu_torch.vm.interpreter import (ExecContext, ExecuteResult,
                                        FinalizeCall, MappingStore,
                                        execute_finalize, execute_function,
                                        open_record, parse_plaintext,
                                        program_address, record_serial,
                                        seal_record)
from snarkos_tpu_torch.vm.program import ParseError, Program, parse_program
from snarkos_tpu_torch.vm.values import (HaltError, Value, format_value,
                                   parse_literal, parse_typed)

__all__ = [
    "ExecContext", "ExecuteResult", "FinalizeCall", "MappingStore",
    "execute_finalize", "execute_function", "ParseError", "Program",
    "parse_program", "HaltError", "Value", "format_value", "parse_literal",
    "parse_typed", "program_address",
]
