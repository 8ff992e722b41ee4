"""Closing the loop on device: alert -> command actuation.

Declarative per-tenant alert->command policies compile into fixed-shape
tables the step evaluates right after anomaly scoring (ops/actuate.py); the
command lane fans out through the commands/ destinations
(actuation/dispatcher.py); anomaly-model constants refit from accumulated
feature moments when the fleet drifts (actuation/refit.py).
"""

from sitewhere_tpu_torch.actuation.compiler import (  # noqa: F401
    ActuationPolicyError, ActuationPolicyTable, PolicySource,
    compile_policy_into, dry_run_compile, empty_policy_table,
    policy_from_dict)
from sitewhere_tpu_torch.actuation.store import ActuationPolicyStore  # noqa: F401
from sitewhere_tpu_torch.actuation.dispatcher import (  # noqa: F401
    CommandFanout, deliver_via_service)
from sitewhere_tpu_torch.actuation.refit import DriftRefitter  # noqa: F401
