// Native BVH builder for cg_raytracer.
//
// Reference capability: BoundingVolumeHierarchy::createTree
// (src/bounding_volume_hierarchy.cpp:42-464): binary tree,
// longest-axis centroid-median split, depth cap, flat node vector.  This is a
// fresh implementation around a globally reordered triangle-index buffer (leaves
// store [first, first+count) ranges instead of copied meshes) producing the flat
// SoA layout both traversals (jnp and CUDA) consume.  Exposed with a C ABI for ctypes.
//
// Build: make -C native  (produces libcgrt.so)

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct BuildTask {
  int node;
  int begin;
  int end;
  int depth;
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.
// Output arrays must have capacity for 2*num_tris+1 nodes; `order` must be
// initialised to the identity permutation of length num_tris.
int cgrt_build_bvh(const float* tri_lo, const float* tri_hi,
                   const float* centroids, int num_tris, int max_depth,
                   int max_leaf, float* node_lo, float* node_hi, int* left,
                   int* right, int* first, int* count, int* order) {
  if (num_tris <= 0 || max_leaf <= 0) return -1;
  const int max_nodes = 2 * num_tris + 1;
  int num_nodes = 0;

  auto new_node = [&]() -> int {
    if (num_nodes >= max_nodes) return -1;
    const int n = num_nodes++;
    left[n] = -1;
    right[n] = -1;
    first[n] = 0;
    count[n] = 0;
    return n;
  };

  std::vector<BuildTask> stack;
  stack.reserve(64);
  const int root = new_node();
  stack.push_back({root, 0, num_tris, 0});

  while (!stack.empty()) {
    const BuildTask task = stack.back();
    stack.pop_back();
    const int ni = task.node;

    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = task.begin; i < task.end; ++i) {
      const int t = order[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], tri_lo[3 * t + a]);
        hi[a] = std::max(hi[a], tri_hi[3 * t + a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      node_lo[3 * ni + a] = lo[a];
      node_hi[3 * ni + a] = hi[a];
    }

    const int n = task.end - task.begin;
    if (n <= max_leaf || task.depth >= max_depth) {
      first[ni] = task.begin;
      count[ni] = n;
      continue;
    }

    int axis = 0;
    float ext = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a) {
      const float e = hi[a] - lo[a];
      if (e > ext) {
        ext = e;
        axis = a;
      }
    }

    const int mid = task.begin + n / 2;
    std::nth_element(order + task.begin, order + mid, order + task.end,
                     [&](int a, int b) {
                       return centroids[3 * a + axis] < centroids[3 * b + axis];
                     });

    const int li = new_node();
    const int ri = new_node();
    if (li < 0 || ri < 0) return -1;
    left[ni] = li;
    right[ni] = ri;
    stack.push_back({ri, mid, task.end, task.depth + 1});
    stack.push_back({li, task.begin, mid, task.depth + 1});
  }

  return num_nodes;
}

}  // extern "C"
