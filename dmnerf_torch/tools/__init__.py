"""Command-line tools of the port: the reference-format stress scenes
(make_stress_scenes) and the drill that trains, renders, edits and meshes
them through the CLIs (stress_drill); the train step's trace and its reader
(trace_step); the LPIPS weight converter (convert_lpips); and the readers of
a run's records (quality_curve, check_resume_replay)."""
