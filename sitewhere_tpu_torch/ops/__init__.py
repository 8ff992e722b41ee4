"""Device ops of the step: wire pack/unpack, rules, geofence (plain + CUDA
kernel), keyed folds, alert-lane compaction, and the stateful stages (rule
programs, anomaly models, actuation) over fused state slabs."""
