"""io layer of tpuray_torch: numpy readers and writers for scene assets
(OBJ, Radiance HDR, BMP, PNG, TGA) and the asset-root search."""
