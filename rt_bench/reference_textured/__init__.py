"""The textured Sponza's plain reference: the default reference's scene and
path tracer with UVs, albedo, bump and alpha maps.  It imports nothing of
the program under test."""
