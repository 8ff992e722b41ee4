"""Streaming rule processing (reference: service-rule-processing) plus
the CEP-lite rule-program compiler (specs -> program tables)."""

from sitewhere_tpu_torch.rules.compiler import (
    ProgramOp, RuleProgramError, RuleProgramTable, program_from_dict)
from sitewhere_tpu_torch.rules.processor import (
    RuleProcessor, RuleProcessorHost, RuleProcessorsManager,
    ScriptedRuleProcessor, ZoneTestRuleProcessor)

__all__ = ["RuleProcessor", "RuleProcessorHost", "RuleProcessorsManager",
           "ScriptedRuleProcessor", "ZoneTestRuleProcessor",
           "ProgramOp", "RuleProgramError", "RuleProgramTable",
           "program_from_dict"]
