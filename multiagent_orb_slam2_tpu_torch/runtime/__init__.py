"""Per-agent SLAM runtime: tracking, local mapping, keyframe management,
as state-in/state-out steps sequenced by a thin host orchestrator."""
