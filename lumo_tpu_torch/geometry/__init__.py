"""Ray-primitive intersection and shading-frame helpers."""
