"""Command-line tools of the port: the reference-format stress scenes
(make_stress_scenes) and the drill that trains, renders, edits and meshes
them through the CLIs (stress_drill)."""
