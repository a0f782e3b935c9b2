// Native OBJ/MTL loader for cg_raytracer.
//
// Reference capability: assimp import with aiProcess_GenNormals |
// aiProcess_Triangulate (src/mesh.cpp:58-141).  This is a
// fresh C++ implementation of the exact semantics of the pure-Python loader
// (cg_raytracer/scene/loader.py) — one mesh per usemtl group in first-use
// order, (position-index, normal-index) vertex dedup, flat generated normals
// with fresh vertices when the file has none, fan triangulation, negative
// index handling, MTL Kd/Ks/Ns/d.  The Python loader stays as the fallback
// and as the executable spec; tests assert array-for-array equality.
//
// C ABI: handle-based two-phase protocol for ctypes —
//   cgrt_load_obj(path)            -> handle (0 on error)
//   cgrt_obj_num_meshes(h)         -> M
//   cgrt_obj_mesh_sizes(h, i, ...) -> num_vertices / num_triangles
//   cgrt_obj_mesh_data(h, i, ...)  -> fills caller-allocated arrays
//   cgrt_obj_free(h)
//
// Build: make -C native  (part of libcgrt.so)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Material {
  float kd[3] = {0.6f, 0.6f, 0.6f};
  float ks[3] = {0.0f, 0.0f, 0.0f};
  float shininess = 1.0f;
  float transparency = 1.0f;
};

struct Mesh {
  Material material;
  std::vector<float> positions;  // xyz triplets
  std::vector<float> normals;    // xyz triplets
  std::vector<int32_t> triangles;
  std::map<std::pair<int64_t, int64_t>, int32_t> vert_map;

  int32_t add_vertex(const float* pos, const float* normal,
                     const std::pair<int64_t, int64_t>* key) {
    if (key != nullptr) {
      auto it = vert_map.find(*key);
      if (it != vert_map.end()) return it->second;
    }
    const int32_t idx = static_cast<int32_t>(positions.size() / 3);
    positions.insert(positions.end(), pos, pos + 3);
    normals.insert(normals.end(), normal, normal + 3);
    if (key != nullptr) vert_map.emplace(*key, idx);
    return idx;
  }
};

struct ObjFile {
  std::vector<Mesh> meshes;
};

std::vector<std::string> split_ws(const std::string& line) {
  std::vector<std::string> out;
  std::istringstream is(line);
  std::string tok;
  while (is >> tok) out.push_back(tok);
  return out;
}

// Matches Python float(): parse as double, callers cast to float when stored.
double parse_f(const std::string& s) { return std::strtod(s.c_str(), nullptr); }

// OBJ indices are 1-based; negative indices are relative to the end.
int64_t parse_index(const std::string& tok, int64_t count) {
  const long long i = std::strtoll(tok.c_str(), nullptr, 10);
  return i > 0 ? i - 1 : count + i;
}

std::string dirname_of(const std::string& path) {
  const auto pos = path.find_last_of('/');
  return pos == std::string::npos ? std::string(".") : path.substr(0, pos);
}

void load_mtl(const std::string& path, std::map<std::string, Material>* out) {
  std::ifstream f(path);
  if (!f.is_open()) return;
  std::string line;
  Material* cur = nullptr;
  while (std::getline(f, line)) {
    const auto parts = split_ws(line);
    if (parts.empty() || parts[0][0] == '#') continue;
    const std::string& key = parts[0];
    if (key == "newmtl") {
      const std::string name = parts.size() > 1 ? parts[1] : "";
      cur = &(*out)[name];
      *cur = Material();
    } else if (cur == nullptr) {
      continue;
    } else if (key == "Kd" && parts.size() >= 4) {
      for (int k = 0; k < 3; ++k) cur->kd[k] = static_cast<float>(parse_f(parts[1 + k]));
    } else if (key == "Ks" && parts.size() >= 4) {
      for (int k = 0; k < 3; ++k) cur->ks[k] = static_cast<float>(parse_f(parts[1 + k]));
    } else if (key == "Ns" && parts.size() >= 2) {
      cur->shininess = static_cast<float>(parse_f(parts[1]));
    } else if (key == "d" && parts.size() >= 2) {
      cur->transparency = static_cast<float>(parse_f(parts[1]));
    }
  }
}

}  // namespace

extern "C" {

void* cgrt_load_obj(const char* path) {
  std::ifstream f(path);
  if (!f.is_open()) return nullptr;

  std::vector<double> positions;     // xyz triplets (double, cast at emit)
  std::vector<double> file_normals;  // xyz triplets
  std::map<std::string, Material> materials;
  auto obj = new ObjFile();
  // usemtl-group builders in first-use order: name -> index into obj->meshes.
  std::map<std::string, size_t> builder_index;
  std::string cur_mat;
  const std::string objdir = dirname_of(path);

  auto get_builder = [&](const std::string& name) -> Mesh& {
    auto it = builder_index.find(name);
    if (it == builder_index.end()) {
      obj->meshes.emplace_back();
      auto mit = materials.find(name);
      if (mit != materials.end()) obj->meshes.back().material = mit->second;
      it = builder_index.emplace(name, obj->meshes.size() - 1).first;
    }
    return obj->meshes[it->second];
  };

  std::string line;
  while (std::getline(f, line)) {
    const auto parts = split_ws(line);
    if (parts.empty() || parts[0][0] == '#') continue;
    const std::string& key = parts[0];
    if (key == "v" && parts.size() >= 4) {
      for (int k = 0; k < 3; ++k) positions.push_back(parse_f(parts[1 + k]));
    } else if (key == "vn" && parts.size() >= 4) {
      for (int k = 0; k < 3; ++k) file_normals.push_back(parse_f(parts[1 + k]));
    } else if (key == "mtllib" && parts.size() >= 2) {
      std::string name = parts[1];
      for (size_t k = 2; k < parts.size(); ++k) name += " " + parts[k];
      load_mtl(objdir + "/" + name, &materials);
    } else if (key == "usemtl") {
      cur_mat = parts.size() > 1 ? parts[1] : "";
    } else if (key == "f" && parts.size() >= 4) {
      Mesh& b = get_builder(cur_mat);
      struct Corner { int64_t vi, vni; };
      std::vector<Corner> corners;
      bool has_normals = true;
      for (size_t t = 1; t < parts.size(); ++t) {
        const std::string& tok = parts[t];
        const auto s1 = tok.find('/');
        const auto s2 = s1 == std::string::npos ? std::string::npos
                                                : tok.find('/', s1 + 1);
        const int64_t vi =
            parse_index(tok.substr(0, s1), static_cast<int64_t>(positions.size() / 3));
        int64_t vni = -1;
        if (s2 != std::string::npos && s2 + 1 < tok.size()) {
          vni = parse_index(tok.substr(s2 + 1),
                            static_cast<int64_t>(file_normals.size() / 3));
        } else {
          has_normals = false;
        }
        corners.push_back({vi, vni});
      }
      std::vector<int32_t> idxs;
      if (has_normals) {
        for (const auto& c : corners) {
          float pos[3], nrm[3];
          for (int k = 0; k < 3; ++k) {
            pos[k] = static_cast<float>(positions[3 * c.vi + k]);
            nrm[k] = static_cast<float>(file_normals[3 * c.vni + k]);
          }
          const std::pair<int64_t, int64_t> dedup(c.vi, c.vni);
          idxs.push_back(b.add_vertex(pos, nrm, &dedup));
        }
      } else {
        // aiProcess_GenNormals: flat face normal in f32 arithmetic (matches the
        // Python loader's np.float32 cross/norm); fresh vertices so the flat
        // normal never bleeds across faces.
        float p[3][3];
        for (int c = 0; c < 3; ++c)
          for (int k = 0; k < 3; ++k)
            p[c][k] = static_cast<float>(positions[3 * corners[c].vi + k]);
        float e1[3], e2[3], fn[3];
        for (int k = 0; k < 3; ++k) {
          e1[k] = p[1][k] - p[0][k];
          e2[k] = p[2][k] - p[0][k];
        }
        fn[0] = e1[1] * e2[2] - e1[2] * e2[1];
        fn[1] = e1[2] * e2[0] - e1[0] * e2[2];
        fn[2] = e1[0] * e2[1] - e1[1] * e2[0];
        const float ln = std::sqrt(fn[0] * fn[0] + fn[1] * fn[1] + fn[2] * fn[2]);
        if (ln > 0.0f) {
          for (int k = 0; k < 3; ++k) fn[k] /= ln;
        } else {
          fn[0] = 0.0f; fn[1] = 1.0f; fn[2] = 0.0f;
        }
        for (const auto& c : corners) {
          float pos[3];
          for (int k = 0; k < 3; ++k)
            pos[k] = static_cast<float>(positions[3 * c.vi + k]);
          idxs.push_back(b.add_vertex(pos, fn, nullptr));
        }
      }
      // Fan triangulation (aiProcess_Triangulate).
      for (size_t k = 1; k + 1 < idxs.size(); ++k) {
        b.triangles.push_back(idxs[0]);
        b.triangles.push_back(idxs[k]);
        b.triangles.push_back(idxs[k + 1]);
      }
    }
  }

  // Drop triangle-less groups (Python: finish() -> None).
  std::vector<Mesh> kept;
  for (auto& m : obj->meshes)
    if (!m.triangles.empty()) kept.push_back(std::move(m));
  obj->meshes = std::move(kept);
  if (obj->meshes.empty()) {
    delete obj;
    return nullptr;
  }
  return obj;
}

int cgrt_obj_num_meshes(void* handle) {
  return handle ? static_cast<int>(static_cast<ObjFile*>(handle)->meshes.size()) : -1;
}

int cgrt_obj_mesh_sizes(void* handle, int i, int32_t* num_vertices,
                        int32_t* num_triangles) {
  if (!handle) return -1;
  const auto& meshes = static_cast<ObjFile*>(handle)->meshes;
  if (i < 0 || i >= static_cast<int>(meshes.size())) return -1;
  *num_vertices = static_cast<int32_t>(meshes[i].positions.size() / 3);
  *num_triangles = static_cast<int32_t>(meshes[i].triangles.size() / 3);
  return 0;
}

// material: kd[3], ks[3], shininess, transparency (8 floats).
int cgrt_obj_mesh_data(void* handle, int i, float* vertices, float* normals,
                       int32_t* triangles, float* material) {
  if (!handle) return -1;
  const auto& meshes = static_cast<ObjFile*>(handle)->meshes;
  if (i < 0 || i >= static_cast<int>(meshes.size())) return -1;
  const Mesh& m = meshes[i];
  std::memcpy(vertices, m.positions.data(), m.positions.size() * sizeof(float));
  std::memcpy(normals, m.normals.data(), m.normals.size() * sizeof(float));
  std::memcpy(triangles, m.triangles.data(), m.triangles.size() * sizeof(int32_t));
  std::memcpy(material, m.material.kd, 3 * sizeof(float));
  std::memcpy(material + 3, m.material.ks, 3 * sizeof(float));
  material[6] = m.material.shininess;
  material[7] = m.material.transparency;
  return 0;
}

void cgrt_obj_free(void* handle) { delete static_cast<ObjFile*>(handle); }

}  // extern "C"
